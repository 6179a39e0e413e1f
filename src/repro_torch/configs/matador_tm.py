"""The paper's own models (Table II) + a pod-scale TM for the dry-run.

Feature counts follow the paper's datasets: MNIST/FMNIST/KMNIST 784-bit
binarized images, KWS6 377-bit MFCC booleans, CIFAR-2 1024-bit.
``clause_pad_multiple`` aligns the flattened clause axis to the model mesh
axis (padded clauses are permanently empty and vote 0 — DESIGN.md §4).
"""

from repro_torch.core.tm import TMConfig

TM_MNIST = TMConfig(n_features=784, n_classes=10, clauses_per_class=200,
                    threshold=50, s=10.0, clause_pad_multiple=256)
TM_KMNIST = TMConfig(n_features=784, n_classes=10, clauses_per_class=500,
                     threshold=100, s=10.0, clause_pad_multiple=256)
TM_FMNIST = TMConfig(n_features=784, n_classes=10, clauses_per_class=500,
                     threshold=100, s=10.0, clause_pad_multiple=256)
TM_CIFAR2 = TMConfig(n_features=1024, n_classes=2, clauses_per_class=1000,
                     threshold=200, s=15.0, clause_pad_multiple=256)
TM_KWS6 = TMConfig(n_features=377, n_classes=6, clauses_per_class=300,
                   threshold=60, s=10.0, clause_pad_multiple=256)

# Pod-scale TM (the "larger edge application datasets" the paper's future
# work targets): 4096 boolean features, 32 classes, 2048 clauses/class.
TM_EDGE_XL = TMConfig(n_features=4096, n_classes=32, clauses_per_class=2048,
                      threshold=400, s=10.0, clause_pad_multiple=256)

# Drill-sized TM for fault-tolerance exercises (tests, CI): synthetic data
# (non-paper name), seconds to train, small enough that every engine on the
# serve ladder traces quickly.
TM_TINY = TMConfig(n_features=32, n_classes=3, clauses_per_class=8,
                   threshold=8, s=4.0)

TM_CONFIGS = {
    "tm-mnist": TM_MNIST, "tm-kmnist": TM_KMNIST, "tm-fmnist": TM_FMNIST,
    "tm-cifar2": TM_CIFAR2, "tm-kws6": TM_KWS6, "tm-edge-xl": TM_EDGE_XL,
    "tm-tiny": TM_TINY,
}
