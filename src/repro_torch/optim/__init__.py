"""Optimizers and learning-rate schedules of the DP baseline."""
from repro_torch.optim.optimizers import adam, adamw, sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
