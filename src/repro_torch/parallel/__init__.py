from .sharding import MeshRules, current_rules, lsc, make_rules, use_rules

__all__ = ["MeshRules", "current_rules", "lsc", "make_rules", "use_rules"]
