"""One run of one benchmark cell: set-up, the measured window, the traced
layer readings, the comparison with the plain reference, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is data found by name: ``BENCHMARK.json`` at the checkout's root
names the cell; its configuration file (``configs/<name>.json``) states the
parameters, the program's profile of them and the plain reference (its
``reference``: a module's path, which every run is judged by); its mix
(``traffic/<name>.json``) is read by :mod:`benchmark.traffic`, and the
mix's ``op`` names the module ``ops/<op>.py`` that makes its requests,
calls the program and gives the reference's outputs (the interface is in
:mod:`benchmark.traffic`'s docstring); each per-layer metric is a reader
``metrics/<name>.py`` whose ``read(obs)`` returns a number, or None when
the run gave it nothing to read.

A new op is one file under ``ops/`` and a mix that names it: the harness
asks the op how many ``engine.bootstrap`` calls a request makes, and
judges every output ciphertext that its calls return.

The program is measured through its public entries only: the key material
goes in through ``keys.cloud_key_from_numpy``, a call is the op's
(``ops/gate.py``: ``gates.<GATE>``; ``ops/lut.py``:
``lut.bootstrap_func``), and the layer spans time ``engine.bootstrap`` and
``engine.bootstrap_without_key_switch`` on the op's arguments.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

from . import traffic, yardstick

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that no run may load (compared whole: the program
# is go_tfhe_tpu_torch, the JAX package go_tfhe_tpu).
FORBIDDEN = ("jax", "jaxlib", "flax", "go_tfhe_tpu")
GIB = float(1 << 30)
# The numbers of a configuration that must equal the program's profile.
PROFILE_FIELDS = ("lwe_n", "lwe_alpha", "n", "nbit", "lv1_alpha", "bgbit",
                  "l", "basebit", "iks_t", "block_size", "message_modulus",
                  "poly_extend_factor", "kernel_limb_drop", "key_grid_bits",
                  "centered_decomposition")
SPAN_REPS = {True: 5, False: 3}      # layer-span repetitions: chain, batch
PROFILED_CALLS = {True: 10, False: 2}


def forbidden_modules(names) -> list:
    """The FORBIDDEN top-level names among module names."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    ref: object           # the plain reference module it names
    mix: dict             # the traffic mix
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    ops_dir: str = traffic.OPS_DIR      # where the mix's op is found


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its configuration,
    the plain reference that the configuration names, mix and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    if "reference" not in config:
        raise ValueError(f"{entry['file']}: the configuration names no "
                         f"reference")
    mix = traffic.load(os.path.join(BENCH_DIR, "traffic",
                                    cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, cell["chips"], config,
                load_reference(config["reference"], root), mix, e2e,
                per_layer)


def _load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load_reference(path: str, root: str = ROOT):
    """The plain reference module at ``path``, relative to the checkout's
    root (a configuration's ``reference``), loaded by path."""
    if os.path.isabs(path) or os.path.normpath(path).startswith(".."):
        raise ValueError(f"reference {path!r} lies outside the checkout")
    return _load_module("benchmark_reference_" + re.sub(r"\W", "_", path),
                        os.path.join(root, path))


def load_reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py``."""
    return _load_module("benchmark_metric_" + name.replace(".", "_"),
                        os.path.join(BENCH_DIR, "metrics", name + ".py"))


def check_profile(port_params, params: dict) -> None:
    """The program's profile must be the configuration as stated."""
    for field in PROFILE_FIELDS:
        if field in params and getattr(port_params, field) != params[field]:
            raise ValueError(
                f"profile {port_params.name!r}: {field} = "
                f"{getattr(port_params, field)!r}, the configuration "
                f"states {params[field]!r}")


def _reset_program_records() -> None:
    """Zero the program's records that the readers of source
    ``program_counter`` read: ``utils/tracing``'s spans, peaks and counts,
    and ``ops/cuda_t``'s launch counts.  A program without them has
    nothing to zero."""
    try:
        tracing = importlib.import_module("go_tfhe_tpu_torch.utils.tracing")
        cuda_t = importlib.import_module("go_tfhe_tpu_torch.ops.cuda_t")
    except ImportError:
        return
    tracing.reset()
    cuda_t.reset_launch_counts()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


def digest(out: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One int64 per ciphertext: sum of its words times odd weights,
    mod 2^64.  An odd weight is invertible mod 2^64, so a change of one
    word always changes the digest."""
    return (out.to(torch.int64) * weights).sum(-1)


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------

class Run:
    """One run of a cell on ``device`` (the card; the CPU only in the
    benchmark's own tests, at a toy profile)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device,
                 t_process: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device = torch.device(device)
        self.t_process = t_process
        self.split: dict = {}
        self.obs: dict = {}

    def _mark(self, key: str, t0: float) -> float:
        now = time.time()
        self.split[key] = now - t0
        return now

    def make_data(self) -> None:
        """The benchmark's data, from the seed: key material, the mix's
        inputs and the digest weights, made on the device; host copies of
        the raw cloud key (the program's input and the reference's)."""
        t0 = time.time()
        self.split["start_s"] = t0 - self.t_process
        ref = self.cell.ref
        self.prm = ref.Params.from_config(self.cell.config["params"])
        self.traffic = traffic.Traffic(self.cell.mix, ref, self.prm,
                                       self.device, self.cell.ops_dir)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        keys = ref.make_keys(gen, self.prm)
        self.inputs = self.traffic.make_inputs(gen, keys)
        weights = torch.randint(-(1 << 62), 1 << 62, (self.prm.lwe_n + 1,),
                                generator=gen, device=self.device)
        self.weights = weights | 1
        self.raw = {k: _u32(keys.pop(k)) for k in ("bsk", "ksk", "testvec")}
        self.keys = keys                              # lv0, lv1
        _sync(self.device)
        self._mark("key_material_s", t0)

    def setup(self) -> None:
        """Data, then the program's set-up from the raw key and one warm
        call of the cell's own shapes.  The memory peak and the program's
        records count from the hand-over of the key on."""
        self.make_data()
        t0 = time.time()
        import go_tfhe_tpu_torch as port
        self.port = port
        cfg = self.cell.config
        check_profile(port.get_params(cfg["profile"]), cfg["params"])
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        _reset_program_records()
        t0 = self._mark("import_program_s", t0)
        self.ck = port.keys.cloud_key_from_numpy(
            cfg["profile"], self.raw["testvec"], self.raw["ksk"],
            self.raw["bsk"], block_binary=False, device=self.device)
        _sync(self.device)
        t0 = self._mark("program_setup_s", t0)
        warm = self.traffic.call(port, self.ck,
                                 self.traffic.request(self.inputs, 0))
        digest(warm, self.weights)
        del warm
        _sync(self.device)
        self._mark("warm_call_s", t0)

    def window(self) -> None:
        """Calls back to back for ``seconds``, each waited for; the last
        call started before the deadline runs to its end and counts."""
        tr, port, ck = self.traffic, self.port, self.ck
        lat, host, digests, outs = [], [], [], []
        prev = None
        _sync(self.device)
        t_start = time.perf_counter()
        self.setup_s = time.time() - self.t_process
        deadline = t_start + self.seconds
        k = 0
        while True:
            req = tr.request(self.inputs, k, prev)
            t0 = time.perf_counter()
            out = tr.call(port, ck, req)
            t_ret = time.perf_counter()
            if tr.chain:
                outs.append(out)
                prev = out
            else:
                digests.append(digest(out, self.weights))
            _sync(self.device)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            host.append(t_ret - t0)
            k += 1
            if t1 >= deadline:
                break
        self.window_s = t1 - t_start
        self.calls = k
        self.latency_s, self.obs["host_return_s"] = lat, host
        self.obs["latency_s"] = lat
        self.outs, self.digests = outs, digests
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        else:
            self.peak_bytes = 0

    # -- traced readings -------------------------------------------------

    def _event_seconds(self, fn) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def spans(self) -> None:
        """engine.bootstrap and engine.bootstrap_without_key_switch on the
        cell's own first input, timed in CUDA events, in turns."""
        engine, ck = self.port.engine, self.ck
        x, tv = self.traffic.engine_args(
            self.port, ck, self.traffic.request(self.inputs, 0))
        fns = {"engine.bootstrap":
               lambda: engine.bootstrap(ck, x, testvec=tv),
               "engine.bootstrap_without_key_switch":
               lambda: engine.bootstrap_without_key_switch(ck, x, tv)}
        for fn in fns.values():
            fn()
        _sync(self.device)
        times = {name: [] for name in fns}
        for _ in range(SPAN_REPS[self.traffic.chain]):
            for name, fn in fns.items():
                times[name].append(self._event_seconds(fn))
        self.obs["spans"] = times

    def profile(self) -> None:
        """A few of the cell's own calls under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile, record_function
        tr, port, ck = self.traffic, self.port, self.ck
        calls = PROFILED_CALLS[tr.chain]
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prev = None
        _sync(self.device)
        with profile(activities=activities) as prof:
            with record_function("benchmark.window"):
                for k in range(calls):
                    out = tr.call(port, ck, tr.request(self.inputs, k, prev))
                    prev = out if tr.chain else None
                    _sync(self.device)
        device_ops, host_ops, window = [], [], None
        for e in prof.events():
            s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # operations on the card; not the annotations that mirror
                # host ranges there, nor the host's waits on a full queue
                if not (getattr(e, "is_user_annotation", False)
                        or e.name in ("benchmark.window",
                                      "Command Buffer Full")):
                    device_ops.append((e.name, s, t,
                                       not e.name.startswith(("Memcpy",
                                                              "Memset"))))
            elif e.name == "benchmark.window":
                window, thread = (s, t), e.thread
        host_ops = [(e.name, e.time_range.start / 1e6,
                     e.time_range.end / 1e6) for e in prof.events()
                    if e.device_type != torch.autograd.DeviceType.CUDA
                    and e.thread == thread and e.name != "benchmark.window"]
        self.obs["profile"] = yardstick.reduce_trace(
            device_ops, host_ops, window[0], window[1], calls)

    # -- the comparison ----------------------------------------------------

    def judge(self) -> dict:
        """The plain reference over what the window produced: every call's
        outputs, against the reference's on the same inputs.  Returns
        {"attempted": the output ciphertexts compared, "failed",
        "wrong_plaintexts", "reference_s"}."""
        t0 = time.time()
        dev, ref = self.device, self.cell.ref
        boot = ref.Bootstrap(
            self.prm, torch.from_numpy(self.raw["bsk"].view(np.int32)).to(dev),
            torch.from_numpy(self.raw["ksk"].view(np.int32)).to(dev))
        tv = torch.from_numpy(self.raw["testvec"].view(np.int32)).to(dev)
        tr, b, inputs = self.traffic, self.traffic.batch, self.inputs
        if tr.chain:
            reqs, prev = [], None
            for k in range(self.calls):
                reqs.append(tr.request(inputs, k, prev))
                prev = self.outs[k]
            want = tr.reference(
                boot,
                {key: torch.cat([r[key] for r in reqs]) for key in reqs[0]},
                tv)
            mismatched = (want != torch.cat(self.outs)).any(-1)
            attempted, failed = mismatched.numel(), int(mismatched.sum())
            # the plaintexts of the chain, step by step
            decrypted, plain, wrong = tr.decrypt(want, self.keys), None, 0
            for k in range(self.calls):
                plain = tr.expected(inputs, k, plain)
                wrong += int((decrypted[k * b:(k + 1) * b] != plain).sum())
        else:
            distinct = tr.mix["distinct_batches"]
            want_dig, wrong = [], 0
            deviations = []
            for k in range(distinct):
                want = tr.reference(boot, tr.request(inputs, k), tv)
                want_dig.append(digest(want, self.weights))
                expected = tr.expected(inputs, k)
                wrong += int((tr.decrypt(want, self.keys) != expected).sum())
                off = tr.deviations(want, expected, self.keys)
                if off is not None:
                    deviations += off
            if deviations:
                self.obs["noise_sigmas"] = yardstick.noise_sigmas(deviations)
            attempted = sum(d.numel() for d in self.digests)
            failed = sum(int((d != want_dig[k % distinct]).sum())
                         for k, d in enumerate(self.digests))
        _sync(dev)
        return {"attempted": attempted, "failed": failed,
                "wrong_plaintexts": wrong, "reference_s": time.time() - t0}

    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""
        self.ck = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the result --------------------------------------------------------

    def end_to_end(self) -> dict:
        lat_ms = [1e3 * s for s in self.latency_s]
        values = {
            "bootstraps_per_s": self.calls * self.traffic.bootstrap_calls()
            * self.traffic.batch / self.window_s,
            "latency_p50_ms": yardstick.percentile(lat_ms, 50),
            "latency_p95_ms": yardstick.percentile(lat_ms, 95),
            "peak_mem_gib": self.peak_bytes / GIB,
            "setup_s": self.setup_s,
        }
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end}

    def per_layer(self) -> dict:
        self.obs.update(params=self.cell.config["params"],
                        batch=self.traffic.batch, calls=self.calls,
                        bootstrap_calls=self.traffic.bootstrap_calls())
        out = {}
        for m in self.cell.per_layer:
            value = load_reader(m["name"]).read(self.obs)
            if value is not None and math.isfinite(value):
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, log=sys.stderr) -> dict:
    """Set-up, window, (traced readings,) comparison: the result line as a
    dict, its compared numbers under "checks" last."""
    r = Run(cell, seed, seconds, device, t_process)
    r.setup()
    r.window()
    if trace:
        r.spans()
        r.profile()
    r.free_program()
    verdict = r.judge()
    result = {"correct": verdict["failed"] == 0 and verdict["attempted"] > 0,
              "attempted": verdict["attempted"], "failed": verdict["failed"]}
    result["metrics"] = r.per_layer() if trace else r.end_to_end()
    dev = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(r.device)
                    if r.device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(r.peak_bytes)}
    if trace:
        prof = r.obs["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["device"] = dev
    result.update(
        workload=cell.name, seed=seed, seconds=seconds, trace=int(trace),
        calls=r.calls, window_s=r.window_s, setup_split=r.split,
        reference_s=verdict["reference_s"],
        wrong_plaintexts=verdict["wrong_plaintexts"])
    print(f"info: {r.calls} calls of {r.traffic.batch} in {r.window_s} s; "
          f"set-up {r.split}; reference {verdict['reference_s']} s; "
          f"plaintexts decrypted wrong (the profile's noise, not compared) "
          f"{verdict['wrong_plaintexts']}; margin "
          f"{r.obs.get('noise_sigmas')} sigma", file=log)
    result["checks"] = {"mismatched_ciphertexts": {
        "value": verdict["failed"], "limit": 0}}
    return result
