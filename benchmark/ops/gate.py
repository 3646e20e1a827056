"""The op ``gate``: the two-input gate of the program's ``gates`` module
that the mix's ``gate`` names, on ``batch`` ciphertext pairs a call; one
``engine.bootstrap`` call a request.

Batch mixes: ``distinct_batches`` batches whose operands carry the truth
table, each of the four input pairs a quarter of a batch, in an order
drawn from the seed.  Chains: each call's first operand is the previous
call's output (the first from the seed), its second the next of the mix's
``fresh_inputs`` ciphertexts made from the seed, in turn.
"""

from __future__ import annotations

import torch

from benchmark import traffic

KEYS = {"gate", "fresh_inputs"}


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


class Op(traffic.Op):

    def __init__(self, mix: dict, ref, prm):
        super().__init__(mix, ref, prm)
        self.gate = mix.get("gate")
        if self.gate not in ref.GATES:
            raise ValueError(f"no gate {self.gate!r}")
        if prm.message_modulus != 2:
            raise ValueError("gates need a boolean profile")

    def bootstrap_calls(self) -> int:
        return 1

    # -- inputs ---------------------------------------------------------

    def _encrypt(self, gen, plain, keys) -> torch.Tensor:
        return self.ref.lwe_encrypt(gen, self.ref.encode_bool(plain),
                                    self.prm.lwe_alpha, keys["lv0"])

    def _plain(self, gen, batch) -> torch.Tensor:
        return torch.randint(0, self.prm.message_modulus, (batch,),
                             generator=gen, device=gen.device)

    def make_inputs(self, gen: torch.Generator, keys: dict) -> dict:
        """Batch mixes: ``{"batches": [{"a", "b", "plain_a", "plain_b"}]}``;
        chains: ``{"first", "plain_first", "fresh", "plain_fresh"}``."""
        if self.chain:
            first = self._plain(gen, self.batch)
            out = {"plain_first": first,
                   "first": self._encrypt(gen, first > 0, keys)}
            n = self.mix["fresh_inputs"]
            fresh = self._plain(gen, n * self.batch) > 0
            out["plain_fresh"] = fresh.reshape(n, self.batch)
            out["fresh"] = self._encrypt(gen, fresh, keys).reshape(
                n, self.batch, -1)
            return out
        batches = []
        for _ in range(self.mix["distinct_batches"]):
            pa, pb = _bits(gen, self.batch)
            batches.append({"plain_a": pa, "plain_b": pb,
                            "a": self._encrypt(gen, pa, keys),
                            "b": self._encrypt(gen, pb, keys)})
        return {"batches": batches}

    def request(self, inputs: dict, k: int, previous=None) -> dict:
        if not self.chain:
            batches = inputs["batches"]
            return batches[k % len(batches)]
        a = inputs["first"] if previous is None else previous
        fresh = inputs["fresh"]
        return {"a": a, "b": fresh[k % fresh.shape[0]]}

    def expected(self, inputs: dict, k: int, previous=None) -> torch.Tensor:
        truth = self.ref.TRUTH[self.gate]
        if not self.chain:
            req = self.request(inputs, k)
            return truth(req["plain_a"], req["plain_b"])
        a = inputs["plain_first"] > 0 if previous is None else previous
        fresh = inputs["plain_fresh"]
        return truth(a, fresh[k % len(fresh)])

    # -- the program ----------------------------------------------------

    def call(self, port, ck, req: dict) -> torch.Tensor:
        return getattr(port.gates, self.gate)(ck, req["a"], req["b"])

    def engine_args(self, port, ck, req: dict) -> tuple:
        prepare = getattr(port.engine, "prepare_" + self.gate.lower())
        return prepare(req["a"], req["b"]), None

    # -- the reference --------------------------------------------------

    def reference(self, boot, req: dict, testvec: torch.Tensor):
        return boot(self.ref.gate_input(self.gate, req["a"], req["b"]),
                    testvec)

    def decrypt(self, out: torch.Tensor, keys: dict) -> torch.Tensor:
        return self.ref.decrypt_bool(out, keys["lv0"])

    def deviations(self, out, plain, keys) -> list:
        """Each output's phase less its ideal +-1/8, as signed words."""
        ideal = self.ref.encode_bool(plain)
        off = (self.ref.phase(out, keys["lv0"]) - ideal
               + (1 << 31)) % (1 << 32) - (1 << 31)
        return off.tolist()
