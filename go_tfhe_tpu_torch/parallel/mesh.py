"""The batch-sharded bootstrap over several devices and processes
(port of ``go_tfhe_tpu/parallel/mesh.py``, its names and contracts).

The bootstrap is embarrassingly parallel over independent ciphertexts, so
the one sharding is the JAX module's: the ciphertext batch axis is split
over the mesh, and the keys (bands, KSK, test vector) are replicated on
each device.  Nothing inside the blind rotation communicates.

How the port differs from the JAX module:

* A mesh is an ordered tuple of ``torch.device``s, one batch shard each,
  not a ``jax.sharding.Mesh``: the batch is always the leading axis, so no
  axis name is taken.  A mesh may name one device more than once (torch has
  one ``cpu`` device and no virtual ones; on a card the shards then run
  one after the other on it).
* :func:`shard_batch` returns the list of shards and :func:`replicate_keys`
  a dict of one ``CloudKey.to(d)`` per distinct device, where JAX places
  one global array.
* Each shard runs ``engine`` under ``torch.cuda.device(d)`` (its kernels
  launch on d: ops/cuda_t.launch).  Every shard is launched before any
  result is read, so the cards overlap; the outputs are concatenated in
  batch order on the input's device.
* :func:`sharded_bootstrap_cuda`, the counterpart of
  ``sharded_bootstrap_pallas``, runs the per-bit core that the JAX
  function picks (:func:`_pallas_rotation`), never the block rotation:
  K1/K2 on a transposed key, K1/K9 with ``engine.PREFER_PIPE``, K7/K8 or
  K3 on a ``transposed=False`` key.  Both refuse a key without a Pallas
  band (N % 256 != 0) and extended profiles (poly_extend_factor > 1).
* Multi-process: :func:`multihost_initialize` starts a
  ``torch.distributed`` process group where JAX starts
  ``jax.distributed``.  With a group of W > 1 processes up, every rank
  passes the whole global batch; rank r bootstraps its contiguous W-th of
  it over its own mesh, and the outputs are all-gathered so that every
  rank returns the whole batch in order (on ``gloo`` the batch lives on
  the host, on ``nccl`` on the rank's card).  The keys are replicated on
  every rank, as the JAX module's docstring has them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import engine
from ..keys import CloudKey

BATCH_AXIS = "batch"

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over every CUDA device, or over the given devices (names
    or ``torch.device``s, repeats allowed).  Raises RuntimeError when no
    devices are given and there is no CUDA device."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass the devices to make a mesh on the host")
        devices = [torch.device("cuda", i) for i in range(count)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: an empty mesh")
    return mesh


def _split(x: torch.Tensor, parts: int, what: str) -> List[torch.Tensor]:
    if x.shape[0] % parts:
        raise ValueError(f"{what}: batch {x.shape[0]} is not divisible by "
                         f"{parts} shards")
    return list(torch.chunk(x, parts))


def shard_batch(mesh: Mesh, ct: torch.Tensor) -> List[torch.Tensor]:
    """The leading (batch) axis of ``ct`` split into len(mesh) equal
    contiguous shards, shard i on mesh[i]."""
    return [s.to(d) for s, d in zip(_split(ct, len(mesh), "shard_batch"),
                                    mesh)]


def replicate_keys(mesh: Mesh, ck: CloudKey) -> Dict[torch.device, CloudKey]:
    """One copy of the key on each distinct device of the mesh (the key
    itself where it already lies there)."""
    return {d: ck.to(d) for d in dict.fromkeys(mesh)}


def _device_scope(d: torch.device):
    return (torch.cuda.device(d) if d.type == "cuda"
            else contextlib.nullcontext())


def _process_group() -> Tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _run_sharded(mesh: Mesh, ck: CloudKey, ct: torch.Tensor, testvec,
                 run: Callable) -> torch.Tensor:
    """run(key, ct shard, testvec shard) on each shard of this rank's part
    of the batch, launched in turn on its device; the outputs concatenated
    in batch order on ct's device and, across ranks, all-gathered."""
    world, rank = _process_group()
    p = ck.params
    if ct.shape[0] % (world * len(mesh)):
        raise ValueError(f"sharded bootstrap: batch {ct.shape[0]} is not "
                         f"divisible by {world} process(es) x {len(mesh)} "
                         "shards")
    tv_rank = 2 if p.poly_extend_factor == 1 else 3
    per_ct = testvec is not None and testvec.dim() > tv_rank
    if world > 1:
        ct = _split(ct, world, "sharded bootstrap")[rank]
        if per_ct:
            testvec = _split(testvec, world, "sharded bootstrap")[rank]
    keys = replicate_keys(mesh, ck)
    shards = shard_batch(mesh, ct)
    if per_ct:
        tvs = shard_batch(mesh, testvec)
    else:
        tvs = [None if testvec is None else testvec.to(d) for d in mesh]
    outs = []
    for d, x, tv in zip(mesh, shards, tvs):
        with _device_scope(d):
            outs.append(run(keys[d], x, tv))
    out = torch.cat([o.to(ct.device) for o in outs])
    if world > 1:
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous())
        out = torch.cat(parts)
    return out


def sharded_bootstrap(mesh: Mesh, ck: CloudKey, ct: torch.Tensor,
                      testvec: torch.Tensor | None = None) -> torch.Tensor:
    """Batched ``engine.bootstrap`` with the batch axis sharded over the
    mesh (and the ranks of a process group).

    ``ct``: (B, lwe_n+1) with B divisible by the mesh size (times the
    process count); ``testvec``: the key's by default, a table shared by
    all ciphertexts, or one per ciphertext (leading axis B, split with
    ``ct``).  The words equal ``engine.bootstrap(ck, ct, testvec)``'s."""
    return _run_sharded(mesh, ck, ct, testvec,
                        lambda key, x, tv: engine.bootstrap(key, x, tv))


def _pallas_rotation(ck: CloudKey) -> str:
    """The blind rotation of ``sharded_bootstrap_pallas``'s core
    (go_tfhe_tpu/parallel/mesh.py:100-106): on a transposed key
    ``blind_rotate_pipe`` with ``engine.PREFER_PIPE`` and single-limb
    digits, else ``blind_rotate_t``; on a ``transposed=False`` key
    ``blind_rotate_tpu``.  Never the block rotation, whatever the key and
    ``engine.PREFER_BLOCK_ROTATION``.  Raises ValueError where the JAX
    function asserts: an extended profile, or an N the Pallas kernels do
    not tile (no band, N % 256 != 0)."""
    p = ck.params
    if p.poly_extend_factor != 1:
        raise ValueError(
            "sharded_bootstrap_cuda: extended profiles are not supported "
            f"({p.name!r}, poly_extend_factor {p.poly_extend_factor}); use "
            "sharded_bootstrap, which routes through engine.bootstrap")
    if p.n % 256:
        raise ValueError(
            f"sharded_bootstrap_cuda: profile {p.name!r} is not "
            f"Pallas-eligible (N {p.n} is not a multiple of 256); use "
            "sharded_bootstrap, which routes through engine.bootstrap")
    if not ck.transposed:
        return "blind_rotate_tpu"
    if engine.PREFER_PIPE and p.digit_limbs == 1:
        return "blind_rotate_pipe"
    return "blind_rotate_t"


def sharded_bootstrap_cuda(mesh: Mesh, ck: CloudKey, ct: torch.Tensor,
                           testvec: torch.Tensor | None = None,
                           key_switch: bool = True) -> torch.Tensor:
    """The counterpart of the JAX ``sharded_bootstrap_pallas``: each shard
    runs the blind rotation of :func:`_pallas_rotation` (which raises
    ValueError where the JAX function asserts), then sample extraction
    and, with ``key_switch``, the identity key switch (without it the
    result is under the level-1 key, as
    ``engine.bootstrap_without_key_switch``'s)."""
    route = _pallas_rotation(ck)
    return _run_sharded(
        mesh, ck, ct, testvec,
        lambda key, x, tv: engine._bootstrap(key, x, tv, key_switch,
                                             plain=False, route=route))


def multihost_initialize(**kwargs) -> None:
    """Multi-process entry point: ``torch.distributed.init_process_group``
    with the given arguments (``backend``, ``init_method`` such as
    ``"tcp://host:port"``, ``world_size``, ``rank``)."""
    dist.init_process_group(**kwargs)
