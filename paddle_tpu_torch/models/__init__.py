"""Models of the port."""
from .mobilenet import build_mobilenet_v3  # noqa: F401
from .resnet import build_resnet, build_resnet50  # noqa: F401
