from .pipeline import TokenStream

__all__ = ["TokenStream"]
