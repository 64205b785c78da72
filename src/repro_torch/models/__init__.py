"""Model code of the port (dense GQA transformer: training and serving;
RWKV6 stack: serving)."""
from repro_torch.models.model import Model, build_model  # noqa: F401
