"""shard_map with the replication-check keyword under its older name.

Callers here spell the check ``check_rep``; the installed jax names it
``check_vma``.
"""

from __future__ import annotations


def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
    import jax

    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check_rep)
