"""Data of the port: synthetic LM token streams (`tokens`) and the seeded
surrogates of the paper's convex datasets (`synthetic`)."""
from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS,
    make_problem,
    surrogate_dataset,
)
