from .pipeline import DataCursor, TokenStream, family_batch

__all__ = ["DataCursor", "TokenStream", "family_batch"]
