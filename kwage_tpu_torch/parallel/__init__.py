"""Distributed runtime of the port: the database-construction scheduler
(``maestro``), the search mesh and its sharded search, and the
multi-process wiring.

Re-exports resolve lazily (PEP 562), as in the JAX package: a host-only
maestro run does not import the mesh modules.
"""

_LAZY = {
    "make_search_mesh": ".mesh",
    "SearchMesh": ".mesh",
    "ShardedDatabase": ".sharded_search",
    "build_sharded_groups": ".sharded_search",
    "search_sharded_groups": ".sharded_search",
    "sharded_search_counts": ".sharded_search",
    "sharded_search_complete": ".sharded_search",
    "sharded_search_files": ".sharded_search",
    "sharded_total_hits": ".sharded_search",
    "to_host": ".sharded_search",
    "init_distributed": ".distributed",
    "make_global_search_mesh": ".distributed",
    "shard_inventory": ".maestro",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        modname = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(modname, __name__), name)
