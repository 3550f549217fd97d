from .logging import MetricsLogger, profile

__all__ = ["MetricsLogger", "profile"]
