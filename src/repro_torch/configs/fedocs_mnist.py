"""Paper §IV-A configuration: multi-sensor MNIST denoising reconstruction.

The paper's hyperparameters: N=4 sensors, 784-d flattened views, encoders
{512, 256, 128} -> K=64 embedding, decoder {128, 256, 512} -> 784,
sigma=2 observation noise, max-pool aggregation.  A copy of the JAX
package's config, returning the port's :class:`VerticalConfig`.
"""

from repro_torch.core.vertical import VerticalConfig

ID = "fedocs-mnist"

N_WORKERS = 4
SIGMA = 2.0
IMAGE_HW = 28


def config(**overrides) -> VerticalConfig:
    defaults = dict(
        n_workers=N_WORKERS,
        input_dim=IMAGE_HW * IMAGE_HW,
        encoder_dims=(512, 256, 128),
        embed_dim=64,
        head_dims=(128, 256, 512),
        output_dim=IMAGE_HW * IMAGE_HW,
        task="reconstruction",
        aggregation="max",
    )
    defaults.update(overrides)
    return VerticalConfig(**defaults)


def reduced(**overrides) -> VerticalConfig:
    defaults = dict(input_dim=64, encoder_dims=(64,), embed_dim=16,
                    head_dims=(64,), output_dim=64)
    defaults.update(overrides)
    return config(**defaults)
