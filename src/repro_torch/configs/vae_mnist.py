"""The paper's own model: the fully-connected VAE for (binarized) MNIST."""
from repro_torch.models.vae import VAEConfig, paper_config

BINARIZED = paper_config("bernoulli")
FULL = paper_config("beta_binomial")

__all__ = ["VAEConfig", "BINARIZED", "FULL"]
