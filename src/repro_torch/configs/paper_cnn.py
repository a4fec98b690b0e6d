"""The paper's own workload analog: small conv-net image classifier.

The paper trains AlexNet on Cifar10 and ResNet34 on ImageNet (§VI).  For the
convergence benchmark (Fig. 4 analog) we use a CPU-feasible conv net on
synthetic 32x32 images — same experimental role (a real gradient-descent
workload under the coding schemes), laptop-scale cost.  Lives outside the
transformer zoo: see benchmarks/fig4_convergence.py for the model definition.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperCNNConfig:
    name: str = "paper-cnn"
    img_size: int = 32
    channels: int = 3
    n_classes: int = 10
    widths: tuple[int, ...] = (32, 64)
    hidden: int = 128


CONFIG = PaperCNNConfig()
