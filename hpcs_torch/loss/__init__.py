from .hyphc import normalize_to_radius

__all__ = ["normalize_to_radius"]
