from .datasets import get_dataset  # noqa: F401
