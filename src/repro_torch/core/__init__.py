"""MATADOR core: the Tsetlin Machine, its training and its
boolean-to-silicon compiler."""

from repro_torch.core.tm import (  # noqa: F401
    TMConfig,
    TMState,
    accuracy,
    class_sums,
    clause_outputs,
    include_mask,
    init,
    literals,
    polarity,
    predict,
    vote_matrix,
)
from repro_torch.core.compiler import (  # noqa: F401
    CompiledTM,
    CompileStats,
    compile_tm,
    predict_compiled,
    run_compiled,
)
from repro_torch.core.train import eval_step, fit, train_step  # noqa: F401


def __getattr__(name):
    # EngineSpec/ENGINE_NAMES live in kernels/ops and are re-exported
    # lazily through compiler: an eager import here would re-open the
    # kernels <-> core import cycle that compiler.__getattr__ breaks
    if name in ("EngineSpec", "ENGINE_NAMES"):
        from repro_torch.core import compiler
        return getattr(compiler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
