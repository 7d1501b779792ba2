"""The process mesh and its groups: the port's CommContext.

The JAX package keeps ring id -> mesh axis over a `jax.sharding.Mesh` of
devices, and XLA emits the collectives. Here one process is one rank of a
`torch.distributed` world, and a `Mesh` lays the world's ranks out on named
axes (`dp`, `tp`, `sp`, `pp`, `ep`), holding for each axis this rank's
process group along it. `new_group` is itself collective, so every rank
creates every group of every axis, in one order. An axis that spans the
whole world takes the default group (at world size 1 too, so a one-rank
NCCL world runs its collectives through NCCL); any other axis of one rank
has no group (an op on it reduces over one value). With no process group
initialized,
`make_mesh()` is a world of one: every axis of size 1.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Mesh", "AxisGroup", "make_mesh", "make_tp_mesh", "axes_desc",
           "CommContext", "get_comm_context", "world", "ceil_range",
           "DATA_AXIS",
           "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS"]

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
SEQ_AXIS = "sp"
PIPE_AXIS = "pp"
EXPERT_AXIS = "ep"


def ceil_range(extent: int, size: int, index: int) -> tuple[int, int]:
    """[start, stop) of the rows that rank `index` of `size` holds of a dim
    of `extent` rows under GSPMD's split: ceil(extent / size) rows a rank,
    the last ranks the rest (which may be none)."""
    k = -(-int(extent) // int(size))
    start = min(index * k, extent)
    return start, min(start + k, extent)


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) with no process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AxisGroup:
    """This rank's group along one mesh axis: the global ranks on it, this
    rank's index among them, the torch.distributed group (None for an axis
    of one rank) and its backend ("nccl" or "gloo"; "" for one rank)."""

    def __init__(self, axis: str, ranks, pg):
        import torch.distributed as dist

        self.axis = axis
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(world()[0])
        self.backend = (str(dist.get_backend(pg)).lower() if pg is not None
                        else "")

    def __repr__(self):
        return (f"AxisGroup({self.axis}, ranks={self.ranks}, "
                f"backend={self.backend or None})")


class Mesh:
    """World ranks laid out on named axes, with this rank's group along
    each. `shape` is {axis: size} in axis order, as a jax Mesh's."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.groups = self._make_groups()

    def _make_groups(self) -> dict:
        import torch.distributed as dist

        me, n = world()
        groups = {}
        for ax_i, ax in enumerate(self.axis_names):
            # every line of ranks along `ax`, in one order on every rank
            moved = np.moveaxis(self.ranks, ax_i, -1)
            lines = moved.reshape(-1, moved.shape[-1]).tolist()
            mine = None
            for line in lines:
                if len(line) == n and dist.is_available() and \
                        dist.is_initialized():
                    pg = dist.group.WORLD
                elif len(line) == 1:
                    pg = None
                else:
                    pg = dist.new_group(line)
                if me in line:
                    mine = AxisGroup(ax, line, pg)
            groups[ax] = mine
        return groups

    def group(self, axis: str) -> AxisGroup:
        if axis not in self.groups:
            raise ValueError(f"mesh axis '{axis}' is not in this mesh "
                             f"{self.axis_names}")
        return self.groups[axis]

    def layout(self) -> tuple:
        """A hashable description of the layout (the executor's cache key)."""
        return (self.axis_names, tuple(self.ranks.reshape(-1).tolist()),
                self.ranks.shape)

    def shard_rows(self, value, axis: str = DATA_AXIS, dim: int = 0):
        """This rank's rows of a global value along `axis` (along `dim`,
        default the batch's). On the data axis every rank holds B / size
        rows, rows [i*k, (i+1)*k) at index i, and a batch that does not
        divide raises; on any other axis GSPMD's ceil split (`ceil_range`)."""
        g = self.group(axis)
        b = value.shape[dim]
        if axis == DATA_AXIS and b % g.size:
            raise ValueError(f"a batch of {b} rows does not divide over the "
                             f"{g.size} ranks of mesh axis '{axis}'")
        start, stop = ceil_range(b, g.size, g.index)
        index = [slice(None)] * value.ndim
        index[dim] = slice(start, stop)
        return value[tuple(index)]

    def shard_feed(self, feed: dict, axis: str = DATA_AXIS,
                   program=None, strict: bool = True) -> dict:
        """`shard_rows` of every array of a feed along `axis`; a feed is
        whole where this mesh lacks `axis`. With `program`, a feed var
        annotated with mesh axes (`annotate_sharding`) is split along each
        annotated dim over its axis instead, as the JAX package's executor
        splits it. `strict` is shard_map's regime (an annotated axis this
        mesh lacks raises); strict=False is GSPMD's, with_data_parallel's,
        where such an axis is dropped (annotation_spec)."""
        out = {}
        for n, v in feed.items():
            var = (program.global_block.vars.get(n)
                   if program is not None else None)
            spec = getattr(var, "sharding", None)
            if spec is None:
                out[n] = (self.shard_rows(v, axis)
                          if axis in self.axis_names else v)
                continue
            from .sharding import annotation_spec

            for d, ax in enumerate(annotation_spec(self, var, strict=strict)):
                if ax is not None:
                    v = self.shard_rows(v, ax, d)
            out[n] = v
        return out

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape: dict | None = None, places=None, devices=None) -> Mesh:
    """The world's ranks on named axes. Default: every rank on one
    data-parallel axis. `shape` is an ordered {axis: size}; -1 takes the
    remaining ranks. `places` (an int) or `devices` (a list of ranks)
    restricts the mesh to those ranks, which every rank must pass alike."""
    _, n = world()
    ranks = list(range(n)) if devices is None else [int(r) for r in devices]
    if isinstance(places, int):
        ranks = ranks[:places]
    if not shape:
        return Mesh(np.array(ranks), (DATA_AXIS,))
    names, sizes = list(shape.keys()), list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(ranks) // known
    total = int(np.prod(sizes))
    if total > len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} ranks; "
                         f"the world has {len(ranks)}")
    return Mesh(np.array(ranks[:total]).reshape(sizes), tuple(names))


def make_tp_mesh(tp: int, devices=None) -> Mesh:
    """`tp` ranks on MODEL_AXIS and nothing else."""
    _, n = world()
    ranks = list(range(n)) if devices is None else list(devices)
    if int(tp) < 1:
        raise ValueError(f"tp degree must be >= 1, got {tp}")
    if len(ranks) < int(tp):
        raise ValueError(f"tp degree {tp} exceeds the {len(ranks)} ranks of "
                         f"the world")
    return Mesh(np.array(ranks[:int(tp)]), (MODEL_AXIS,))


def axes_desc(mesh_or_nranks) -> str:
    """The mesh component of tuning keys ('dp8', 'dp2tp2sp2'), spelled as
    the JAX package spells it, so both packages key alike. Takes a Mesh or
    a rank count (a dp-only ring)."""
    if isinstance(mesh_or_nranks, (int, np.integer)):
        return f"{DATA_AXIS}{int(mesh_or_nranks)}"
    m = mesh_or_nranks
    return "".join(f"{name}{int(m.shape[name])}" for name in m.axis_names)


class CommContext:
    """ring_id -> mesh axis registry. Ring 0's data axis is a default, not
    a registration: an executor binds unregistered rings to the mesh's
    first axis, and raises on a registration that names a missing axis."""

    def __init__(self):
        self._rings: dict[int, str] = {}
        self.mesh: Mesh | None = None

    def register_ring(self, ring_id: int, axis: str):
        self._rings[ring_id] = axis

    def registered_rings(self):
        return self._rings.keys()

    def unregister_ring(self, ring_id: int):
        self._rings.pop(ring_id, None)

    def axis_of(self, ring_id: int) -> str:
        return self._rings.get(ring_id, DATA_AXIS)

    def axis_env(self, mesh: Mesh) -> dict:
        """{ring id or axis name: AxisGroup} for a run under `mesh`: rings
        0-7 and every registered ring, each on its registered axis (which
        must be the mesh's) or the mesh's first."""
        env = {}
        for ring in sorted(set(range(8)) | set(self._rings)):
            if ring in self._rings:
                ax = self._rings[ring]
                if ax not in mesh.axis_names:
                    raise ValueError(
                        f"collective ring {ring} is registered to mesh axis "
                        f"'{ax}', which is not in this mesh {mesh.axis_names}")
            else:
                ax = mesh.axis_names[0]
            env[ring] = mesh.group(ax)
        for ax in mesh.axis_names:
            env.setdefault(ax, mesh.group(ax))
        return env


_ctx = CommContext()


def get_comm_context() -> CommContext:
    return _ctx

