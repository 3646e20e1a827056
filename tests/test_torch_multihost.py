"""The port's sharded bootstrap across two processes
(go_tfhe_tpu_torch/parallel/mesh.py): the counterpart of
tests/test_multihost.py, with a ``torch.distributed`` process group on the
``gloo`` backend where JAX runs ``jax.distributed``.

The parent takes the JAX package's TEST_FAST keys (tests/conftest.py) and
a NAND batch made by JAX, saves the key with the JAX package's
``save_cloud_key`` and the batch as words, and sets the expected output
from JAX's ``sharded_bootstrap`` on its 8 virtual devices.  Two worker
processes load them with the port's loader, join a group of two on a free
local port (``multihost_initialize``), and each bootstraps its half of the
batch over a mesh of two ``cpu`` shards.  The halves are all-gathered, so
both ranks must return the whole batch, word for word JAX's.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from go_tfhe_tpu import cipher as jcipher  # noqa: E402
from go_tfhe_tpu import engine as jengine  # noqa: E402
from go_tfhe_tpu import keys as jkeys  # noqa: E402
from go_tfhe_tpu.parallel import mesh as jmesh  # noqa: E402
from go_tfhe_tpu_torch import cipher  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32  # noqa: E402

# Runs in each worker.  argv: [script, port, rank, directory]
_WORKER = r"""
import sys
port, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
import torch.distributed as dist
from go_tfhe_tpu_torch import keys
from go_tfhe_tpu_torch.parallel import (make_mesh, multihost_initialize,
                                        sharded_bootstrap)
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32

multihost_initialize(backend="gloo", init_method=f"tcp://localhost:{port}",
                     world_size=2, rank=rank)
assert dist.get_world_size() == 2 and dist.get_rank() == rank
ck = keys.load_cloud_key(f"{d}/ck.npz", device="cpu")
with np.load(f"{d}/ct.npz") as z:
    ct = from_numpy_u32(z["ct"], "cpu")
out = sharded_bootstrap(make_mesh(["cpu", "cpu"]), ck, ct)
np.save(f"{d}/out{rank}.npy", to_numpy_u32(out))
dist.destroy_process_group()
print(f"rank{rank} ok", flush=True)
"""


def test_two_process_group(tmp_path, fast_keys):
    p, sk, ck = fast_keys
    a = np.resize([False, True], 8)
    b = np.resize([False, False, True, True], 8)
    ka, kb = jax.random.split(jax.random.PRNGKey(11))
    ct = jengine.prepare_nand(
        jcipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0),
        jcipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0))
    jkeys.save_cloud_key(str(tmp_path / "ck.npz"), ck)
    np.savez(tmp_path / "ct.npz", ct=np.asarray(ct))
    want = np.asarray(jmesh.sharded_bootstrap(jmesh.make_mesh(), ck, ct))
    np.testing.assert_array_equal(want, np.asarray(jengine.bootstrap(ck, ct)))

    with socket.socket() as s:                       # a free local port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    env.pop("PYTHONSTARTUP", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(rank), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=180)
            outs.append(out)
            assert proc.returncode == 0, f"rank {rank} failed:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank in range(2):
        assert f"rank{rank} ok" in outs[rank]
        np.testing.assert_array_equal(np.load(tmp_path / f"out{rank}.npy"),
                                      want)
    dec = cipher.lwe_decrypt_bool(
        from_numpy_u32(np.load(tmp_path / "out0.npy"), "cpu"),
        from_numpy_u32(np.asarray(sk.lv0), "cpu"))
    np.testing.assert_array_equal(dec.numpy(), ~(a & b))
