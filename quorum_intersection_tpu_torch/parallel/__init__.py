"""The candidate mesh and the multi-process runtime of the sweep and the
frontier (the JAX package's ``parallel/``).

Not ported: ``shard_map_fn`` and ``shard_map_unchecked``, thin wrappers of
JAX's ``shard_map`` with no PyTorch counterpart; the port's mesh sweep
launches one kernel a card over its contiguous share
(:func:`~.mesh.card_shares`) and combines processes with
:func:`~.mesh.mesh_pmin`, and the frontier under a mesh exchanges its
shares on the device or with :func:`~.mesh.mesh_all_gather`.
"""

from quorum_intersection_tpu_torch.parallel.mesh import CANDIDATE_AXIS, candidate_mesh

__all__ = ["candidate_mesh", "CANDIDATE_AXIS"]
