"""The paged KV cache and its page pool (see `paged`)."""
from . import paged
from .paged import PagePool

__all__ = ["paged", "PagePool"]
