"""Input stand-ins for every (arch x shape) dry-run cell
(``repro/launch/specs.py``): ``meta`` tensors, which carry shapes and
types and no data.

The input-shape set (LM family):
  train_4k     seq 4,096   global_batch 256   -> train_step
  train_4k_dp  the same, pure data parallelism (ZeRO-3) for small archs
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> decode_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> decode_step; sub-quadratic
               archs only (recurrentgemma, xlstm)

``[audio]``/``[vlm]`` archs receive precomputed frame/patch embeddings
(the modality frontend is a stub).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    layout: str = "tp"  # "tp" (TP+SP over model) | "dp" (ZeRO-3 pure data)


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "train_4k_dp": ShapeSpec("train_4k_dp", 4096, 256, "train", layout="dp"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name.split("|")[0] == "long_500k":
        return cfg.subquadratic
    return True


def _t(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_name: str, shapes: dict = SHAPES) -> dict:
    """The cell's batch (train, prefill) or inputs (decode) on ``meta``."""
    sp = shapes[shape_name]
    B, S = sp.global_batch, sp.seq_len
    d = cfg.d_model
    act = getattr(torch, cfg.dtype)
    i32 = torch.int32

    if sp.kind == "train":
        if cfg.frontend == "audio_stub":
            return {"embeds": _t((B, S, d), act), "labels": _t((B, S, cfg.n_codebooks), i32)}
        if cfg.frontend == "vision_stub":
            s_img = S // 4
            return {"embeds": _t((B, s_img, d), act), "tokens": _t((B, S - s_img), i32),
                    "labels": _t((B, S - s_img), i32)}
        return {"tokens": _t((B, S), i32), "labels": _t((B, S), i32)}

    if sp.kind == "prefill":
        if cfg.frontend == "audio_stub":
            return {"embeds": _t((B, S, d), act)}
        if cfg.frontend == "vision_stub":
            s_img = S // 4
            return {"embeds": _t((B, s_img, d), act), "tokens": _t((B, S - s_img), i32)}
        return {"tokens": _t((B, S), i32)}

    # decode: one new token against a seq_len-deep cache
    if cfg.frontend == "audio_stub":
        return {"embeds": _t((B, 1, d), act)}
    return {"tokens": _t((B, 1), i32)}


def meta_model(cfg: ModelConfig) -> transformer.Transformer:
    """The model on ``meta``: its parameters' shapes and types, no data."""
    return transformer.Transformer(cfg, None, META)


def caches_for(model: transformer.Transformer, shape_name: str,
               shapes: dict = SHAPES) -> list:
    """The port's per-layer caches of the cell, on the model's device."""
    sp = shapes[shape_name]
    return model.init_caches(sp.global_batch, sp.seq_len)


def cache_specs_struct(cfg: ModelConfig, shape_name: str, shapes: dict = SHAPES,
                       model=None) -> list:
    """The cell's caches in the reference's stacked layout, on ``meta``."""
    model = model or meta_model(cfg)
    return transformer.caches_tree(cfg, caches_for(model, shape_name, shapes))


def params_struct(cfg: ModelConfig, model=None) -> dict:
    """The parameters in the reference's tree layout, on ``meta``."""
    return transformer.params_tree(cfg, model or meta_model(cfg))
