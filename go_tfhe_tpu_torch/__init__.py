"""go_tfhe_tpu_torch — the PyTorch and CUDA port of ``go_tfhe_tpu``.

A second package beside the JAX one, with the same module names and the
same array layouts at every public function (torus words as ``torch.int32``
with the uint32 bits).  It imports ``torch`` and numpy, never ``jax``.  The
blind-rotation step runs hand-written Hopper kernels (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors.

Served: keygen (uniform or block-binary keys), encryption and the linear
ciphertext operations, the batched gate bootstrap, every gate (the ten
two-input gates, ``AND_OR``, ``MUX`` in two bootstraps and one key switch,
``MUX_3GATE``, ``NOT``, ``COPY``, ``constant``), bit packing
(``bitutils``), the circuit library (``models.adders``: ripple-carry,
many-LUT and the 3-PBS nibble adder ``add8_pbs``; ``models.comparators``),
proxy re-encryption (``proxyreenc``), programmable bootstrapping (``lut``:
shared and per-ciphertext tables) and the many-LUT bootstrap on the plain
profiles, extended look-up tables at uint6, uint7 and uint8 (and their
centered variants), the block blind rotation for block-binary keys
(``engine.PREFER_BLOCK_ROTATION``), the row-major per-bit rotation for
keys with ``transposed=False`` (K7 + K8, or the fused step K3 with
``ops.blindrotate.FUSED_STEP``) and the half-batch pipelined rotation
(``engine.PREFER_PIPE``, K1 + K9): every kernel of the JAX package has its
Hopper counterpart.  The card runs ``128bit_fast``, ``uint5``
(``add8_pbs`` and the comparators), ``uint6_centered``, ``uint7_centered``
and ``uint8_centered``.  Keys, tables and constants made from arrays,
files or values go to the card unless the caller passes ``device="cpu"``.

Beside them: ``parallel`` (the batch-sharded bootstrap over a mesh of
devices and the ranks of a ``torch.distributed`` process group, keys
replicated), ``utils.profiling`` (the bootstrap's cost model against the
H100's peaks, ``bootstrap_utilization``, key memory, a ``torch.profiler``
trace scope), ``utils.metrics`` (JSON-line metric records) and
``ops.sample_extract_to_lv0``.  ``examples/torch_*.py`` drive the public
calls, one program for each of the JAX package's five examples.
"""

from . import (bitutils, cipher, engine, gates, keys, lut, models, ops,
               parallel, proxyreenc, utils)
from . import params as params_module
from .cipher import (lwe_decrypt_bool, lwe_decrypt_message, lwe_encrypt_bool,
                     lwe_encrypt_message, lwe_encrypt_torus, lwe_phase)
from .engine import bootstrap, bootstrap_many, bootstrap_without_key_switch
from .keys import (CloudKey, SecretKey, cloud_key_from_numpy, gen_cloud_key,
                   gen_cloud_key_no_ksk, gen_secret_key, load_cloud_key,
                   load_secret_key, save_cloud_key, save_secret_key,
                   secret_key_from_numpy)
from .params import (DEFAULT, P80, P110, P128, P128_FAST, PROFILES,
                     TEST_BLOCK, TEST_EXT2, TEST_EXT3, TEST_FAST, TEST_NIBBLE,
                     TEST_PBS, UINT1, UINT2, UINT3, UINT4, UINT5, UINT6,
                     UINT7, UINT8, TFHEParams, get_params, security_info)

__version__ = "0.1.0"
