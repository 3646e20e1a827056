"""The general traffic generator: one traffic mix, a data file under
``benchmark/traffic/``, turned into the inputs and calls of a cell.

A mix file holds the common keys

* ``op``: the name of the op, a module ``benchmark/ops/<op>.py`` that
  makes the requests and calls the program (``gate``: a two-input gate of
  the program's ``gates`` module; ``lut``: ``lut.bootstrap_func`` of a
  table);
* ``batch``: ciphertexts (gate pairs) a call;
* ``loop``: ``"closed"``: one caller, each call waiting for its result;
* ``chain``: false: ``distinct_batches`` batches made from the seed, taken
  in turn (call k takes batch k mod ``distinct_batches``); true: each
  call's first operand is the previous call's output (the first from the
  seed);
* ``why``;

and the op's own keys, its ``KEYS``.  A key that is neither is refused.

An op's module holds ``KEYS`` and a class ``Op``, a subclass of
:class:`Op` made from the mix, the plain reference module that the
configuration names and its parameters.  Its methods are the op's
interface:

* ``bootstrap_calls()``: the ``engine.bootstrap`` calls a request makes,
  each of ``batch`` ciphertexts;
* ``make_inputs(gen, keys)``: every input, drawn from the seed's generator
  before the window; inputs are encrypted by the reference's code under
  the benchmark's own keys (``keys``: the reference's ``make_keys``), and
  an op may make further key material here from the reference's code;
  every seed gives the same sizes, so only the values change;
* ``request(inputs, k, previous)``: the operands of call k (``previous``:
  call k-1's output, in a chain);
* ``call(port, ck, req)``: the timed path, through the program's public
  entries only (``port``: the program's package, ``ck`` its cloud key);
  returns the outputs, ``batch`` rows of one or more ciphertexts each,
  every one of which the harness judges;
* ``engine_args(port, ck, req)``: (input, test vector) of one of the
  request's ``engine.bootstrap`` calls, for the layer spans;
* ``reference(boot, req, testvec)``: the outputs that ``call`` must equal
  word for word, from the reference's bootstrap ``boot`` (the plain one,
  or the control) and the gates' constant test vector ``testvec``; in a
  chain ``req`` is the window's requests stacked along the batch;
* ``expected(inputs, k, previous)``: the plaintexts of call k's outputs
  (``previous``: call k-1's, in a chain);
* ``decrypt(out, keys)``: the plaintexts of outputs;
* ``deviations(out, plain, keys)``: the outputs' phases less their ideal
  ones, for the noise margin, or None (the base's).

Adding an op is adding its module under ``benchmark/ops/`` and a mix
that names it.
"""

from __future__ import annotations

import json
import os
import re

COMMON_KEYS = {"op", "batch", "loop", "chain", "distinct_batches", "why"}
OPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ops")


def load_op(name, ops_dir: str = OPS_DIR):
    """The op module ``<ops_dir>/<name>.py``, loaded by path."""
    if (not isinstance(name, str) or os.path.basename(name) != name
            or name.startswith(".")
            or not os.path.isfile(os.path.join(ops_dir, name + ".py"))):
        raise ValueError(f"no op {name!r} in {ops_dir}")
    from . import harness          # which imports this module first
    return harness._load_module("benchmark_op_" + re.sub(r"\W", "_", name),
                                os.path.join(ops_dir, name + ".py"))


def load(path: str, ops_dir: str = OPS_DIR) -> dict:
    with open(path) as f:
        mix = json.load(f)
    op = load_op(mix.get("op"), ops_dir)
    unknown = set(mix) - COMMON_KEYS - set(op.KEYS)
    if unknown:
        raise ValueError(f"{os.path.basename(path)}: unknown keys "
                         f"{sorted(unknown)}")
    if mix.get("loop") != "closed":
        raise ValueError(f"{path}: only closed loops are generated")
    return mix


class Op:
    """The base of an op's class: the mix, the plain reference module
    ``ref`` and its parameters ``prm``, the batch, whether it chains."""

    def __init__(self, mix: dict, ref, prm):
        self.mix, self.ref, self.prm = mix, ref, prm
        self.batch = mix["batch"]
        self.chain = bool(mix.get("chain", False))

    def deviations(self, out, plain, keys):
        return None


class Traffic:
    """The inputs and calls of one mix under one configuration: the mix,
    the plain reference module ``ref`` that makes and judges its data, and
    the mix's op, whose attributes and methods it answers for."""

    def __init__(self, mix: dict, ref, prm, device, ops_dir: str = OPS_DIR):
        self.mix, self.ref, self.prm, self.device = mix, ref, prm, device
        self.op = load_op(mix["op"], ops_dir).Op(mix, ref, prm)

    def __getattr__(self, name):
        if name == "op":                # not made: no op to answer
            raise AttributeError(name)
        return getattr(self.op, name)
