"""Ulysses sequence parallelism (counterpart of
`ray_tpu/parallel/ulysses.py`): all-to-all head <-> sequence resharding.

Instead of rotating KV (the ring), each rank trades its sequence block
for a block of heads with one all-to-all (`collectives.all_to_all`), runs
full-sequence attention on its heads / sp heads, and trades back. Cheaper
than the ring where heads >= sp and the whole sequence fits a rank after
the swap; the ring wins at extreme lengths. As the JAX package's, the
inner attention is the plain dense `reference_attention` (no kernel).
Every entry point takes and returns this rank's local blocks [batch,
seq / sp, heads, head_dim].
"""

from __future__ import annotations

from ray_tpu_torch.parallel.collectives import all_to_all
from ray_tpu_torch.parallel.mesh import axis_group
from ray_tpu_torch.parallel.ring_attention import reference_attention


def ulysses_attention_inner(q, k, v, group, causal: bool = True):
    """This rank's pass over `group` (the sp axis's process group, None
    for one rank): q, k, v [batch, seq_local, heads, head_dim]; heads must
    divide by the group's size."""
    # sequence-cut -> head-cut: split the heads (2), gather the sequence (1)
    qh, kh, vh = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = reference_attention(qh, kh, vh, causal=causal)  # [B, S, H/sp, D]
    return all_to_all(out, group, 1, 2)                   # [B, S/sp, H, D]


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True):
    """Ulysses attention over the mesh axis `axis_name` on this rank's
    blocks (every rank of the mesh calls alike); `mesh` None is one
    rank."""
    return ulysses_attention_inner(q, k, v, axis_group(mesh, axis_name),
                                   causal=causal)
