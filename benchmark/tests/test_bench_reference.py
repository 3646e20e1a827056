"""The plain reference against the program, word for word, at the
program's toy profiles on the CPU (the program's plain kernel versions),
and the control's lower precision against the reference."""

import numpy as np
import pytest
import torch

from benchmark.reference import tfhe as ref
from conftest import PROFILE_OF

FIELDS = ("lwe_n", "lwe_alpha", "n", "nbit", "lv1_alpha", "bgbit", "l",
          "basebit", "iks_t", "message_modulus", "poly_extend_factor",
          "centered_decomposition")


def _setup(p, seed=7):
    from go_tfhe_tpu_torch import keys
    prm = ref.Params.from_config({f: getattr(p, f) for f in FIELDS})
    gen = torch.Generator().manual_seed(seed)
    km = ref.make_keys(gen, prm)
    u32 = {k: km[k].numpy().view(np.uint32) for k in ("testvec", "ksk", "bsk")}
    ck = keys.cloud_key_from_numpy(p, u32["testvec"], u32["ksk"], u32["bsk"],
                                   device="cpu")
    return prm, gen, km, ck


@pytest.mark.parametrize("gate", sorted(ref.GATES))
def test_every_gate_equals_the_program(gate):
    from go_tfhe_tpu_torch import gates, params
    prm, gen, km, ck = _setup(params.get_params(PROFILE_OF["nand"]))
    bits = torch.arange(16) % 4
    a, b = bits >= 2, bits % 2 == 1
    ca = ref.lwe_encrypt(gen, ref.encode_bool(a), prm.lwe_alpha, km["lv0"])
    cb = ref.lwe_encrypt(gen, ref.encode_bool(b), prm.lwe_alpha, km["lv0"])
    got = getattr(gates, gate)(ck, ca, cb)
    want = ref.Bootstrap(prm, km["bsk"], km["ksk"])(
        ref.gate_input(gate, ca, cb), km["testvec"])
    assert torch.equal(got, want)
    assert torch.equal(ref.decrypt_bool(want, km["lv0"]),
                       ref.TRUTH[gate](a, b))


@pytest.mark.parametrize("profile", ["test_pbs", "toy_uint"])
def test_lut_bootstrap_equals_the_program(profile, toy_uint):
    from go_tfhe_tpu_torch import lut, params
    p = params.get_params(profile)
    prm, gen, km, ck = _setup(p)
    m = prm.message_modulus
    table = [(3 * x + 1) % m for x in range(m)]
    msgs = torch.arange(2 * m) % m
    ct = ref.lwe_encrypt(gen, ref.encode_message(msgs, m), prm.lwe_alpha,
                         km["lv0"])
    tv = ref.lut_testvec(prm, table, m, "cpu")
    assert torch.equal(lut.Generator(p, m, device="cpu").gen_lut(
        lambda x: table[x]), tv)
    got = lut.bootstrap_func(ck, ct, lambda x: table[x], m)
    want = ref.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    assert torch.equal(got, want)
    assert torch.equal(ref.decrypt_message(want, m, km["lv0"]),
                       torch.tensor(table)[msgs])


def test_the_reference_keys_decrypt_at_a_uint_gadget(toy_uint):
    """The benchmark's key material is sound TFHE at a three-limb gadget:
    the control, with the key's low byte dropped, decrypts wrong there."""
    prm, gen, km, _ = _setup(toy_uint, seed=11)
    m = prm.message_modulus
    table = list(range(m))
    msgs = torch.arange(4 * m) % m
    ct = ref.lwe_encrypt(gen, ref.encode_message(msgs, m), prm.lwe_alpha,
                         km["lv0"])
    tv = ref.lut_testvec(prm, table, m, "cpu")
    exact = ref.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    lower = ref.Bootstrap(prm, km["bsk"], km["ksk"], key_bits=24)(ct, tv)
    assert torch.equal(ref.decrypt_message(exact, m, km["lv0"]), msgs)
    assert (lower != exact).any(-1).all()


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    from conftest import ROOT
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.tfhe, benchmark.yardstick, "
            "benchmark.traffic; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('go_tfhe')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
