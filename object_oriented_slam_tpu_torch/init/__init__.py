from .svd_incremental import IncrementalQuadricInit  # noqa: F401
