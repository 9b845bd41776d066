"""Models of the port."""
from .mobilenet import build_mobilenet_v3  # noqa: F401
