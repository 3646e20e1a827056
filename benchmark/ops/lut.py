"""The op ``lut``: the program's ``lut.bootstrap_func`` of the function
that the mix's ``table`` lists, message by message, over the
configuration's message modulus, on ``batch`` ciphertexts a call; one
``engine.bootstrap`` call a request.

Batch mixes: ``distinct_batches`` batches of messages uniform from the
seed.  Chains: each call's input is the previous call's output (the first
from the seed).
"""

from __future__ import annotations

import torch

from benchmark import traffic

KEYS = {"table"}


class Op(traffic.Op):

    def __init__(self, mix: dict, ref, prm):
        super().__init__(mix, ref, prm)
        m = prm.message_modulus
        self.table = [int(v) % m for v in mix["table"]]
        if len(self.table) != m:
            raise ValueError(f"table of {len(self.table)} messages for "
                             f"modulus {m}")

    def bootstrap_calls(self) -> int:
        return 1

    # -- inputs ---------------------------------------------------------

    def _encrypt(self, gen, plain, keys) -> torch.Tensor:
        mu = self.ref.encode_message(plain, self.prm.message_modulus)
        return self.ref.lwe_encrypt(gen, mu, self.prm.lwe_alpha,
                                    keys["lv0"])

    def _plain(self, gen, batch) -> torch.Tensor:
        return torch.randint(0, self.prm.message_modulus, (batch,),
                             generator=gen, device=gen.device)

    def make_inputs(self, gen: torch.Generator, keys: dict) -> dict:
        """Batch mixes: ``{"batches": [{"a", "plain_a"}]}``; chains:
        ``{"first", "plain_first"}``."""
        if self.chain:
            first = self._plain(gen, self.batch)
            return {"plain_first": first,
                    "first": self._encrypt(gen, first, keys)}
        batches = []
        for _ in range(self.mix["distinct_batches"]):
            pa = self._plain(gen, self.batch)
            batches.append({"plain_a": pa,
                            "a": self._encrypt(gen, pa, keys)})
        return {"batches": batches}

    def request(self, inputs: dict, k: int, previous=None) -> dict:
        if not self.chain:
            batches = inputs["batches"]
            return batches[k % len(batches)]
        return {"a": inputs["first"] if previous is None else previous}

    def expected(self, inputs: dict, k: int, previous=None) -> torch.Tensor:
        if not self.chain:
            a = self.request(inputs, k)["plain_a"]
        else:
            a = inputs["plain_first"] if previous is None else previous
        return torch.tensor(self.table, device=a.device)[a]

    # -- the program ----------------------------------------------------

    def call(self, port, ck, req: dict) -> torch.Tensor:
        table = self.table
        return port.lut.bootstrap_func(ck, req["a"], lambda x: table[x],
                                       self.prm.message_modulus)

    def engine_args(self, port, ck, req: dict) -> tuple:
        table = self.table
        gen = port.lut.Generator(ck.params, self.prm.message_modulus,
                                 device=req["a"].device)
        return req["a"], gen.gen_lut(lambda x: table[x])

    # -- the reference --------------------------------------------------

    def reference(self, boot, req: dict, testvec: torch.Tensor):
        """``testvec`` (the gates') is not used: the table's own."""
        tv = self.ref.lut_testvec(self.prm, self.table,
                                  self.prm.message_modulus, req["a"].device)
        return boot(req["a"], tv)

    def decrypt(self, out: torch.Tensor, keys: dict) -> torch.Tensor:
        return self.ref.decrypt_message(out, self.prm.message_modulus,
                                        keys["lv0"])
