from .bcr import TorchBwt  # noqa: F401
