#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sarlacc_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/<config>.json``
for its settings and limits, ``benchmark/configs/<config>.py`` for its
chain of entry points and its check) and a traffic mix
(``benchmark/mixes/<traffic>.json``); each metric is read by
``benchmark/metrics/<metric>.py``, or, where there is none, by the reader
of the name with its last dotted part taken off (``device.idle_share``
reads ``device.idle_share.correction``).  The run makes its reads from the seed
on the card, warms up on a slice of them, then runs whole passes over the
chunk until ``--seconds`` have passed and the pass in progress has ended.
With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from spans, the stage profiler and a
device trace of the window.  After the window it checks the last pass
against the plain reference (``benchmark/reference/``) and prints each
number compared beside its limit, on standard error and as the last key
of the result: the JSON object on the last line of standard output.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Where the harness finds a traffic mix and a metric's reader by name.
MIXES = os.path.join(BENCH, "mixes")
METRICS = os.path.join(BENCH, "metrics")

#: Top-level modules that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "sarlacc_tpu")


def _file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, spec: dict | None = None):
    """(cell, config, mix, chain, end-to-end metrics, per-layer metrics)."""
    if spec is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            spec = json.load(fh)
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(MIXES, cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    chain = _file_module(os.path.join(BENCH, "configs", cell["config"] + ".py"),
                          "benchmark_config_" + cell["config"].replace(".", "_").replace("-", "_"))

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return (cell, config, mix, chain, [m for m in spec["end_to_end"] if applies(m)],
            [m for m in spec["per_layer"] if applies(m)])


def reader_path(name: str) -> str:
    """The file of the reader of metric ``name``: its own, or that of the
    longest stem of it (the name cut at a dot) that has one."""
    stem = name
    while not os.path.exists(os.path.join(METRICS, stem + ".py")) and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    return os.path.join(METRICS, stem + ".py")


def reader(name: str):
    return _file_module(reader_path(name), "benchmark_metric_" + name.replace(".", "_")).read


def host_facts() -> str:
    """The machine's cores and the card's name and power limit."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return f"host: os.cpu_count()={os.cpu_count()}; card: {smi or 'none'}"


def _gap_names(gaps, host):
    """Idle seconds by the innermost host interval covering each gap's
    midpoint (intervals nest, as spans and stages of one thread do)."""
    iv = sorted(host, key=lambda x: (x[1], -x[2]))
    mids = sorted(((g[0] + g[1]) // 2, g[1] - g[0]) for g in gaps)
    out: dict[str, float] = {}
    stack, k = [], 0
    for mid, dur in mids:
        while k < len(iv) and iv[k][1] <= mid:
            stack.append(iv[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = next((s[0] for s in reversed(stack) if s[2] >= mid),
                    "outside the entry points")
        out[name] = out.get(name, 0.0) + dur / 1e9
    return [[n, v] for n, v in sorted(out.items(), key=lambda x: -x[1])[:10]]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             spec: dict | None = None, mix_update: dict | None = None) -> dict:
    """One run of ``workload``: the result object, with ``check`` last.
    ``device="cpu"`` runs the program's plain versions (rehearsal and tests
    only); ``mix_update`` overrides keys of the mix (the tests' sizes)."""
    import torch

    from benchmark.roofline import LaunchRecorder
    from benchmark.trace import DeviceTrace, NativeRecorder, Spans, StageRecorder
    from sarlacc_tpu_torch.utils.profiling import PipelineProfiler, set_profiler

    cell, config, mix, chain, e2e, layer = load_cell(workload, spec)
    mix.update(mix_update or {})
    cuda = torch.device(device).type == "cuda"
    inp = chain.make_inputs(config, mix, seed, device)
    chain.warm_pass(inp, Spans(sync=False))
    spans = Spans(sync=trace)
    launches = LaunchRecorder(chain.KERNELS) if trace else None
    native = NativeRecorder() if trace else None
    stages = StageRecorder() if trace else PipelineProfiler()
    set_profiler(stages)
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - _T0

    R = len(inp.reads)
    attempted = failed = done = 0
    digests, last, pass_s = [], None, []
    tracer = DeviceTrace() if (trace and cuda) else contextlib.nullcontext()
    for rec in (launches, native):
        if rec is not None:
            rec.on = True
    with tracer:
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        while True:
            attempted += R
            tp = time.perf_counter()
            try:
                out = chain.run_pass(inp, inp.batch, spans)
                if cuda:
                    torch.cuda.synchronize()
                done += R
                digests.append(out.digest())
                last = out
            except Exception:  # a failed pass counts its reads; the window goes on
                failed += R
                traceback.print_exc(file=sys.stderr)
            pass_s.append(time.perf_counter() - tp)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    for rec in (launches, native):
        if rec is not None:
            rec.on = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    obs = {"reads": done, "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak,
           "spans": spans, "stages": {k: v.seconds for k, v in stages.stages.items()},
           "trace": tracer if isinstance(tracer, DeviceTrace) else None, "busy_s": 0.0,
           "bounds": launches.bounds() if launches else {},
           "native_s": native.seconds if native else None,
           "native_calls": native.calls if native else 0}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if obs["trace"] is not None:
        busy, gaps = obs["trace"].busy(t0_ns, t1_ns)
        obs["busy_s"] = busy
        device_info.update(busy_s=busy, window_s=(t1_ns - t0_ns) / 1e9)
        breakdown = {"device_ops": obs["trace"].top_ops(10),
                     "idle_gaps": _gap_names(gaps, spans.intervals + stages.intervals)}
    metrics = {}
    for m in (layer if trace else e2e):
        v = reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for rec in (launches, native):
        if rec is not None:
            rec.close()
    del obs, tracer
    set_profiler(PipelineProfiler())
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    print(f"setup {setup_s:.2f} s; passes (s): {', '.join(f'{x:.3f}' for x in pass_s)}",
          file=sys.stderr)
    t_check = time.perf_counter()
    try:
        numbers = chain.check(inp, last, seed, digests) if last is not None else []
    except Exception:  # outputs the check cannot read: not correct
        traceback.print_exc(file=sys.stderr)
        numbers = [("check_raised", 1, 0)]
    correct = last is not None and failed == 0 and all(v <= lim for _, v, lim in numbers)
    print(f"check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": float(v), "limit": float(lim)} for n, v, lim in numbers}
    return result


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = int(load_cell(args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(host_facts(), flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
