"""The port's version, kept apart so any module can import it."""

__version__ = "0.1.0"
