from .pipeline import TokenStream, family_batch

__all__ = ["TokenStream", "family_batch"]
