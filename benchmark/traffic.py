"""The general traffic generator: one traffic mix, a data file under
``benchmark/traffic/``, turned into the inputs and calls of a cell.

A mix file holds these keys:

* ``op``: ``"gate"`` (a two-input gate of the program's ``gates`` module,
  named by ``gate``) or ``"lut"`` (``lut.bootstrap_func`` of the function
  that ``table`` lists, message by message, over the configuration's
  message modulus);
* ``batch``: ciphertexts (gate pairs) a call;
* ``loop``: ``"closed"``: one caller, each call waiting for its result;
* ``chain``: false: ``distinct_batches`` batches made from the seed, taken
  in turn; true: each call's first operand is the previous call's output
  (the first from the seed), a gate's second operand the next of
  ``fresh_inputs`` ciphertexts made from the seed, in turn.

Inputs are encrypted by the code of the plain reference that the
configuration names, under the benchmark's own keys; every seed gives the
same sizes, so only the values change.  Gate operands carry the truth
table: each of the four input pairs a quarter of a batch, in an order
drawn from the seed.
"""

from __future__ import annotations

import json
import os

import torch

KEYS = {"op", "gate", "table", "batch", "loop", "chain",
        "distinct_batches", "fresh_inputs", "why"}


def load(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"{os.path.basename(path)}: unknown keys "
                         f"{sorted(unknown)}")
    if mix.get("loop") != "closed":
        raise ValueError(f"{path}: only closed loops are generated")
    if mix["op"] not in ("gate", "lut"):
        raise ValueError(f"{path}: no op {mix['op']!r}")
    return mix


def _bits(gen: torch.Generator, batch: int) -> tuple:
    """(a, b) plaintext bits: the four pairs of the truth table a quarter
    of the batch each (the rest from the seed), in the seed's order."""
    pairs = torch.arange(batch, device=gen.device) % 4
    extra = batch - batch // 4 * 4
    if extra:
        pairs[-extra:] = torch.randint(0, 4, (extra,), generator=gen,
                                       device=gen.device)
    pairs = pairs[torch.randperm(batch, generator=gen, device=gen.device)]
    return pairs >= 2, pairs % 2 == 1


class Traffic:
    """The inputs and calls of one mix under one configuration, its data
    made and judged by the plain reference module ``ref``.

    ``make_inputs`` draws every input before the window; ``call`` is the
    timed path; ``engine_args`` the same work as arguments of the
    program's ``engine`` (for the layer spans); ``reference_args`` the
    plain reference's input and table; ``expected`` the plaintexts that
    the outputs should decrypt to."""

    def __init__(self, mix: dict, ref, prm, device):
        self.mix, self.ref, self.prm, self.device = mix, ref, prm, device
        self.batch = mix["batch"]
        self.chain = bool(mix.get("chain", False))
        self.gate = mix.get("gate")
        if mix["op"] == "gate" and self.gate not in ref.GATES:
            raise ValueError(f"no gate {self.gate!r}")
        if mix["op"] == "lut":
            m = prm.message_modulus
            self.table = [int(v) % m for v in mix["table"]]
            if len(self.table) != m:
                raise ValueError(f"table of {len(self.table)} messages for "
                                 f"modulus {m}")
        elif prm.message_modulus != 2:
            raise ValueError("gates need a boolean profile")

    # -- inputs ---------------------------------------------------------

    def _encrypt(self, gen, plain, keys) -> torch.Tensor:
        if self.gate:
            mu = self.ref.encode_bool(plain)
        else:
            mu = self.ref.encode_message(plain, self.prm.message_modulus)
        return self.ref.lwe_encrypt(gen, mu, self.prm.lwe_alpha,
                                    keys["lv0"])

    def _plain(self, gen, batch) -> torch.Tensor:
        return torch.randint(0, self.prm.message_modulus, (batch,),
                             generator=gen, device=gen.device)

    def make_inputs(self, gen: torch.Generator, keys: dict) -> dict:
        """Batch mixes: ``{"batches": [{"a", "b"?, "plain_a", "plain_b"?}]}``;
        chains: ``{"first", "plain_first", "fresh", "plain_fresh"}``."""
        if self.chain:
            first = self._plain(gen, self.batch)
            out = {"plain_first": first,
                   "first": self._encrypt(gen, first > 0 if self.gate
                                          else first, keys)}
            if self.gate:
                n = self.mix["fresh_inputs"]
                fresh = self._plain(gen, n * self.batch) > 0
                out["plain_fresh"] = fresh.reshape(n, self.batch)
                out["fresh"] = self._encrypt(gen, fresh, keys).reshape(
                    n, self.batch, -1)
            return out
        batches = []
        for _ in range(self.mix["distinct_batches"]):
            if self.gate:
                pa, pb = _bits(gen, self.batch)
                batches.append({"plain_a": pa, "plain_b": pb,
                                "a": self._encrypt(gen, pa, keys),
                                "b": self._encrypt(gen, pb, keys)})
            else:
                pa = self._plain(gen, self.batch)
                batches.append({"plain_a": pa,
                                "a": self._encrypt(gen, pa, keys)})
        return {"batches": batches}

    def request(self, inputs: dict, k: int, previous=None) -> dict:
        """The operands of call k (``previous``: call k-1's output, for a
        chain)."""
        if not self.chain:
            batches = inputs["batches"]
            return batches[k % len(batches)]
        a = inputs["first"] if previous is None else previous
        if not self.gate:
            return {"a": a}
        fresh = inputs["fresh"]
        return {"a": a, "b": fresh[k % fresh.shape[0]]}

    # -- the program ----------------------------------------------------

    def call(self, port, ck, req: dict) -> torch.Tensor:
        """The timed path: the gate, or the PBS, through the program's
        public entry."""
        if self.gate:
            return getattr(port.gates, self.gate)(ck, req["a"], req["b"])
        table = self.table
        return port.lut.bootstrap_func(ck, req["a"], lambda x: table[x],
                                       self.prm.message_modulus)

    def engine_args(self, port, ck, req: dict) -> tuple:
        """(input, test vector) that ``call`` hands ``engine.bootstrap``."""
        if self.gate:
            prepare = getattr(port.engine, "prepare_" + self.gate.lower())
            return prepare(req["a"], req["b"]), None
        table = self.table
        gen = port.lut.Generator(ck.params, self.prm.message_modulus,
                                 device=req["a"].device)
        return req["a"], gen.gen_lut(lambda x: table[x])

    # -- the reference --------------------------------------------------

    def reference_args(self, req: dict, testvec: torch.Tensor) -> tuple:
        """(input, test vector) of the plain bootstrap for ``req``;
        ``testvec``: the gates' constant test vector."""
        if self.gate:
            return (self.ref.gate_input(self.gate, req["a"], req["b"]),
                    testvec)
        return req["a"], self.ref.lut_testvec(self.prm, self.table,
                                              self.prm.message_modulus,
                                              req["a"].device)

    def expected(self, plain_a, plain_b=None) -> torch.Tensor:
        if self.gate:
            return self.ref.TRUTH[self.gate](plain_a, plain_b)
        return torch.tensor(self.table, device=plain_a.device)[plain_a]

    def decrypt(self, out: torch.Tensor, keys: dict) -> torch.Tensor:
        if self.gate:
            return self.ref.decrypt_bool(out, keys["lv0"])
        return self.ref.decrypt_message(out, self.prm.message_modulus,
                                        keys["lv0"])
