"""Helpers shared across the port."""


def remake(seq, items):
    """A tuple or list like `seq` holding `items`: a NamedTuple (an edge set
    of ops/edge_sets.py) keeps its type, filled field by field."""
    return type(seq)(*items) if hasattr(seq, "_fields") else type(seq)(items)
