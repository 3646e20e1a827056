"""The plain reference of the bootstrap over extended tables
(``benchmark/reference/tfhe_ext.py``) against the program, word for word:
on the CPU at the program's toy extended profiles (the kernels' plain
versions), floor and centered decomposition, both extended routes; on the
card at the published widths of uint6-8 (centered).  At k = 1 it gives
``tfhe.py``'s words."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import tfhe, tfhe_ext
from conftest import ROOT

FIELDS = ("lwe_n", "lwe_alpha", "n", "nbit", "lv1_alpha", "bgbit", "l",
          "basebit", "iks_t", "message_modulus", "poly_extend_factor",
          "centered_decomposition")
# The route each key takes (engine._route): K4/K5 for a transposed key
# where the transposed kernels fit, K6/K8 otherwise.
ROUTES = {True: "blind_rotate_extended_t", False: "blind_rotate_extended_rm"}


def _keys(p, ref, seed, device):
    prm = ref.Params.from_config({f: getattr(p, f) for f in FIELDS})
    gen = torch.Generator(device=device).manual_seed(seed)
    km = ref.make_keys(gen, prm)
    return prm, gen, km


def _program_key(p, km, transposed):
    from go_tfhe_tpu_torch import keys
    u32 = {k: km[k].cpu().numpy().view(np.uint32)
           for k in ("testvec", "ksk", "bsk")}
    ck = keys.cloud_key_from_numpy(p, u32["testvec"], u32["ksk"], u32["bsk"],
                                   device=km["bsk"].device)
    return dataclasses.replace(ck, transposed=transposed)


def _messages(gen, prm, km, count):
    m = prm.message_modulus
    msgs = torch.arange(count, device=km["lv0"].device) % m
    ct = tfhe_ext.lwe_encrypt(gen, tfhe_ext.encode_message(msgs, m),
                              prm.lwe_alpha, km["lv0"])
    return msgs, ct, [(3 * x + 1) % m for x in range(m)]


def _profile(name, centered, toy_uint8):
    from go_tfhe_tpu_torch import params
    p = toy_uint8 if name == "toy_uint8" else params.get_params(name)
    return dataclasses.replace(p, centered_decomposition=centered)


@pytest.mark.parametrize("centered", [False, True],
                         ids=["floor", "centered"])
@pytest.mark.parametrize("name", ["test_ext2", "test_ext3", "toy_uint8"])
def test_extended_bootstrap_equals_the_program(name, centered, toy_uint8):
    from go_tfhe_tpu_torch import engine, lut
    p = _profile(name, centered, toy_uint8)
    prm, gen, km = _keys(p, tfhe_ext, 7, "cpu")
    m, k = prm.message_modulus, prm.poly_extend_factor
    msgs, ct, table = _messages(gen, prm, km, 2 * m)
    tv = tfhe_ext.lut_testvec(prm, table, m, "cpu")
    assert tv.shape == (k, 2, prm.n)
    assert torch.equal(lut.Generator(p, m, device="cpu").gen_lut(
        lambda x: table[x]), tv)
    want = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    for transposed, route in ROUTES.items():
        ck = _program_key(p, km, transposed)
        assert engine._route(ck) == route
        assert torch.equal(lut.bootstrap_func(ck, ct, lambda x: table[x], m),
                           want)
    assert torch.equal(tfhe_ext.decrypt_message(want, m, km["lv0"]),
                       torch.tensor(table)[msgs])


@pytest.mark.parametrize("name", ["test_ext2", "test_ext3", "toy_uint8"])
def test_the_control_differs_in_every_ciphertext(name, toy_uint8):
    p = _profile(name, True, toy_uint8)
    prm, gen, km = _keys(p, tfhe_ext, 11, "cpu")
    _, ct, table = _messages(gen, prm, km, 4 * prm.message_modulus)
    tv = tfhe_ext.lut_testvec(prm, table, prm.message_modulus, "cpu")
    exact = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    lower = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"], key_bits=24)(ct, tv)
    assert (lower != exact).any(-1).all()


@pytest.mark.parametrize("name", ["test_pbs", "toy_uint"])
def test_at_k1_it_gives_the_plain_references_words(name, toy_uint):
    from go_tfhe_tpu_torch import params
    p = params.get_params(name)
    prm, gen, km = _keys(p, tfhe_ext, 5, "cpu")
    _, ct, table = _messages(gen, prm, km, 2 * prm.message_modulus)
    m = prm.message_modulus
    plain = tfhe.Params.from_config({f: getattr(p, f) for f in FIELDS})
    _, _, km1 = _keys(p, tfhe, 5, "cpu")
    for key in km:
        assert torch.equal(km[key], km1[key])
    tv = tfhe_ext.lut_testvec(prm, table, m, "cpu")
    assert torch.equal(tv, tfhe.lut_testvec(plain, table, m, "cpu"))
    assert torch.equal(
        tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv),
        tfhe.Bootstrap(plain, km["bsk"], km["ksk"])(ct, tv))
    gate_in = tfhe.gate_input("NAND", ct, ct.flip(0))
    assert torch.equal(
        tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(gate_in,
                                                      km["testvec"]),
        tfhe.Bootstrap(plain, km["bsk"], km["ksk"])(gate_in, km["testvec"]))


# uint8's ring and gadget, one level-0 bit.
RING = {"lwe_n": 1, "lwe_alpha": 0.0, "n": 2048, "nbit": 11, "lv1_alpha": 0.0,
        "bgbit": 22, "l": 1, "basebit": 7, "iks_t": 3}


def test_the_mod_switch_reaches_2kn_and_is_the_shift_form_mod_2n():
    x = torch.tensor([0, 1, 1 << 31, (1 << 32) - 1, 0xABCDEF12, 0x7FFF8000])
    big = 2 * 9 * 2048
    got = tfhe_ext.mod_switch(x, big)
    assert torch.equal(got, (x * big + (1 << 31)) >> 32)
    assert int(got[3]) == big
    prm = tfhe_ext.Params(**RING)
    assert torch.equal(tfhe_ext.mod_switch(x, 2 * 2048) % 4096,
                       tfhe._mod_switch(x, prm))


@pytest.mark.parametrize("big", [36_864, 65_535, 1 << 16])
def test_the_mod_switch_is_exact_mod_2kn_up_to_2_16(big):
    edge = [((j << 32) - (1 << 31)) // big for j in range(1, big + 1)]
    x = torch.tensor(sorted({0, 1, 0xFFFF0000, (1 << 32) - 1, *edge[-64:],
                             *[e + d for e in edge[:64] for d in (-1, 0, 1)]}))
    exact = ((x * big + (1 << 31)) >> 32) % big
    assert torch.equal(tfhe_ext.mod_switch(x, big) % big, exact)


def test_a_table_too_wide_for_the_mod_switch_is_refused():
    tfhe_ext.Params.from_config(dict(RING, poly_extend_factor=16))
    with pytest.raises(ValueError, match="2kN"):
        tfhe_ext.Params.from_config(dict(RING, poly_extend_factor=17))


def test_the_extended_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.tfhe_ext; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('go_tfhe') "
            "or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["uint6_centered", "uint7_centered",
                                  "uint8_centered"])
def test_published_widths_on_the_card(name, card):
    """B 8 at the profile's own widths: every route that a key of it can
    take equals the reference word for word."""
    from go_tfhe_tpu_torch import engine, lut, params
    p = params.get_params(name)
    prm, gen, km = _keys(p, tfhe_ext, 2 ** 31 + 19, card)
    m = prm.message_modulus
    msgs, ct, table = _messages(gen, prm, km, 8)
    got = {}
    for transposed in (True, False):
        ck = _program_key(p, km, transposed)
        got[engine._route(ck)] = lut.bootstrap_func(
            ck, ct, lambda x: table[x], m)
        del ck
    torch.cuda.empty_cache()
    tv = tfhe_ext.lut_testvec(prm, table, m, card)
    want = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    assert set(got) == ({ROUTES[False]} if name == "uint8_centered"
                        else set(ROUTES.values()))
    for out in got.values():
        assert torch.equal(out, want)
    assert torch.equal(tfhe_ext.decrypt_message(want, m, km["lv0"]),
                       torch.tensor(table, device=card)[msgs])
