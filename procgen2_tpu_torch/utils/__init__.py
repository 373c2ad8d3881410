from .tree import bank_gather, tree_map, tree_select

__all__ = ["bank_gather", "tree_map", "tree_select"]
