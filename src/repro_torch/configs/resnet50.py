"""The paper's own benchmark model family, scaled: a conv + BatchNorm net
exercising conv K-FAC (Eq. 10-11) and the unit-wise BN Fisher (Eq. 15-17);
the JAX package's ``repro/configs/resnet50.py``."""
from repro_torch.models.resnet import ConvNetConfig

CONFIG = ConvNetConfig(n_classes=10, widths=(16, 32, 64), blocks_per_stage=2)
