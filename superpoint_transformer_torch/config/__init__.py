from .loader import Config, load_config  # noqa: F401
