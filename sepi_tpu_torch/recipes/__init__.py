from .pipeline import backend_eval, extract_and_score, prepare_features_nosil

__all__ = ["backend_eval", "extract_and_score", "prepare_features_nosil"]
