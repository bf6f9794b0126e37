"""Paper §IV-B configuration: classification from patch grids.

The paper uses MobileNetV2 per worker on CIFAR-10 (2x2 grid, 4 workers) /
CIFAR-100 (3x3 grid, 9 workers) and a {512,512,512} fusion head.  Offline
the same split and head pair with MLP encoders on the synthetic relational
patch task; ``grid``/``n_classes`` pick the CIFAR-10-like (4-worker) or
CIFAR-100-like (9-worker) geometry.  A copy of the JAX package's config,
returning the port's :class:`VerticalConfig`.
"""

from repro_torch.core.vertical import VerticalConfig

ID = "fedocs-cifar"


def config(grid: int = 2, n_classes: int = 10, hw: int = 32,
           **overrides) -> VerticalConfig:
    patch = hw // grid
    defaults = dict(
        n_workers=grid * grid,
        input_dim=patch * patch,
        encoder_dims=(256, 128),          # MobileNetV2 stand-in at MLP scale
        embed_dim=64,
        head_dims=(512, 512, 512),        # the paper's fusion head
        output_dim=n_classes,
        task="classification",
        aggregation="max",
    )
    defaults.update(overrides)
    return VerticalConfig(**defaults)


def cifar10_like(**overrides) -> VerticalConfig:
    return config(grid=2, n_classes=10, **overrides)


def cifar100_like(**overrides) -> VerticalConfig:
    return config(grid=3, n_classes=100, **overrides)


def reduced(**overrides) -> VerticalConfig:
    defaults = dict(encoder_dims=(64,), embed_dim=16, head_dims=(64,))
    defaults.update(overrides)
    return config(**defaults)
