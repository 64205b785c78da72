"""Model code of the port (dense GQA transformer: training and serving)."""
from repro_torch.models.model import Model, build_model  # noqa: F401
