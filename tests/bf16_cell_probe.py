"""Where ``bf16_lstm_scan`` parts from its plain version, on the card.

At SkiM's shape (642 rows, 128 units, two directions) on seeded inputs
(projections N(0, 1), W_hh N(0, 1/H), zero and injected carries), after
one step and after 250: the kernel, the plain version (its dot a float32
matmul) and the plain version with its dot taken in float64 and rounded
once to float32, each against the others (rel-L2 of the outputs and of the
final h and c, and the share of outputs whose bfloat16 differs). Then the
kernel's, the plain version's and cuDNN's bf16 LSTM layer's CUDA-event
medians. One JSON line per reading.

    python tests/bf16_cell_probe.py
    python tests/bf16_cell_probe.py --variants SOURCE

With ``--variants``, what sets the step time of the forward of
``SOURCE`` (an earlier form with the signature
``sonicsim_bf16_lstm_scan(xp, w_hh, bias, h0, c0, y, hn, cn, n, k, dirs,
hidden, mask, device, stream)``, from a ``git archive`` of a commit that
has it) and of this checkout's forward: each source built as it is and
with one part of its
step taken out at a time, by text (``VARIANTS``: the projection's loads,
the gate arithmetic, the products, the output stores, the barrier;
``NEW_VARIANTS``), each timed at SkiM's shape, in two turns; then this
checkout's forward, training forward, backward, step products and running
sum at the same shape, and the backward, its plain version and the plain
version with an exact dot against each other. The variants compute wrong
values and are timed only.

    python tests/bf16_cell_probe.py --backward-variants SOURCE

With ``--backward-variants``, what sets the step time of the backward scan
of ``SOURCE`` (an earlier form, from a ``git archive`` of a commit that has
it) and of this checkout's: each built as it is and with one part of its
step taken out at a time, by text (``BACKWARD_VARIANTS``: the products,
half the products' k tiles, the previous step's c loaded from device
memory, the barrier, the gate tables' loads; a part this checkout's form
no longer has is skipped), timed at SkiM's B=2 x 4 s training shape (516
rows of 250 steps) in two turns, and each form as it is at twice the rows:
a time that holds at twice the rows says half the SMs were idle.

    python tests/bf16_cell_probe.py --train-variants SOURCE

With ``--train-variants``, the same for the training forward (the scan
that also keeps each step's rounded gates and cells) of ``SOURCE`` and of
this checkout: ``TRAIN_VARIANTS`` takes out the kept gates' and cells'
stores, the output stores, the gate tables' loads, the products, the
barrier; at SkiM's training shape in two turns, each form as it is also
at twice the rows; then this checkout's training forward against its
plain version (rel-L2 and the bit-equal share of every output).

Needs the card; imports neither jax nor the JAX package.
"""

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sonicsim_tpu_torch.ops import lstm_cell  # noqa: E402

N, H, DIRS = 642, 128, 2


def plain_f64_dot(xp, w_hh, bias, h0, c0, reverse):
    """``bf16_lstm_scan_ref`` with ``h·W_hhᵀ`` in float64, rounded once to
    float32: the correctly rounded dot."""
    rnd, sig = lstm_cell._rnd, lstm_cell._sigmoid
    n, k, _ = xp.shape
    dirs, gates, hidden = w_hh.shape
    w_t = w_hh.double().transpose(1, 2)
    b = bias.float()[:, None, :]
    x = xp.float().reshape(n, k, dirs, gates)
    h, c = h0.float(), c0.float()
    out = torch.empty(n, k, dirs, hidden, dtype=torch.bfloat16, device=xp.device)
    lanes = torch.arange(dirs, device=xp.device)
    for step in range(k):
        at = torch.tensor([k - 1 - step if r else step for r in reverse], device=xp.device)
        dot = torch.bmm(h.double(), w_t).float()
        z = rnd(rnd(rnd(dot) + b) + x[:, at, lanes].transpose(0, 1))
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        c = rnd(rnd(sig(zf) * c) + rnd(sig(zi) * rnd(torch.tanh(zg))))
        h = rnd(sig(zo) * rnd(torch.tanh(c)))
        out[:, at, lanes] = h.transpose(0, 1).to(torch.bfloat16)
    return out.reshape(n, k, dirs * hidden), h.to(torch.bfloat16), c.to(torch.bfloat16)


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def median_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    xp = bf(rng.standard_normal((N, 250, DIRS * 4 * H)))
    w_hh = bf(rng.standard_normal((DIRS, 4 * H, H)) / np.sqrt(H))
    bias = bf(0.1 * rng.standard_normal((DIRS, 4 * H)))
    zeros = bf(np.zeros((DIRS, N, H)))
    carries = {"zero": (zeros, zeros),
               "injected": (bf(np.tanh(rng.standard_normal((DIRS, N, H)))),
                            bf(rng.standard_normal((DIRS, N, H))))}
    reverse = [False, True]
    for carry, (h0, c0) in carries.items():
        for k in (1, 250):
            args = (xp[:, :k].contiguous(), w_hh, bias, h0, c0, reverse)
            outs = {"kernel": lstm_cell.bf16_lstm_scan(*args),
                    "plain": lstm_cell.bf16_lstm_scan_ref(*args),
                    "plain_f64_dot": plain_f64_dot(*args)}
            torch.cuda.synchronize()
            for a, b in (("kernel", "plain"), ("kernel", "plain_f64_dot"),
                         ("plain", "plain_f64_dot")):
                x, y = outs[a], outs[b]
                print(json.dumps({"carry": carry, "steps": k, "pair": f"{a} vs {b}",
                                  "outputs": rel(x[0], y[0]), "h": rel(x[1], y[1]),
                                  "c": rel(x[2], y[2]),
                                  "flipped": float((x[0] != y[0]).float().mean())}), flush=True)
    args = (xp, w_hh, bias, zeros, zeros, reverse)
    layer = torch.nn.LSTM(64, H, batch_first=True, bidirectional=True).to(dev).bfloat16()
    layer.flatten_parameters()
    x_layer = bf(rng.standard_normal((N, 250, 64)))
    with torch.inference_mode():
        times = {"kernel_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan(*args)),
                 "plain_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan_ref(*args), warmup=1),
                 "cudnn_bf16_lstm_ms": median_ms(lambda: layer(x_layer, (zeros, zeros)))}
    print(json.dumps({"device": torch.cuda.get_device_name(0), **times}), flush=True)


def plain_backward_f64_dot(dy, dhn, dcn, gates, c, w_hh, c0, reverse):
    """``bf16_lstm_scan_backward_ref`` with ``dz·W_hh`` in float64, rounded
    once to float32: the correctly rounded dot."""
    ref = lstm_cell.bf16_lstm_scan_backward_ref
    bmm = torch.bmm
    torch.bmm = lambda a, b: bmm(a.double(), b.double()).float()
    try:
        return ref(dy, dhn, dcn, gates, c, w_hh, c0, reverse)
    finally:
        torch.bmm = bmm


# This checkout's forward with one part of its step taken out.
NEW_VARIANTS = {
    "as-is": ("nothing", []),
    "no-gate-lookups": ("the tables' loads (every gate 0.5)", [
        ("  return from_bits(table[outside ? 0u : ((((b >> 15) * kExps + e) << 7) | (b & 0x7fu))]);",
         "  outside = false;\n  return 0.5f + 0.0f * z;")]),
    "no-products": ("the mma.sync products", [
        ("        mma_bf16(part, a, bw[q][kt][0], bw[q][kt][1]);",
         "        part[0] = __uint_as_float(a[0] ^ bw[q][kt][0]); "
         "part[1] = __uint_as_float(a[1] ^ bw[q][kt][1]);")]),
    "no-barrier": ("the step's __syncthreads", [
        ("    cp_async_wait<kStages - 2>();  // the next step's tile\n    __syncthreads();",
         "    cp_async_wait<kStages - 2>();  // the next step's tile")]),
    "no-output-stores": ("the y stores", [
        ("    if (step > 0) store_h(hb, rev ? t + 1 : t - 1);",
         "    if (step < 0) store_h(hb, rev ? t + 1 : t - 1);")]),
}

# Each variant: (what it takes out of the step, [(text, replacement)]).
VARIANTS = {
    "as-is": ("nothing", []),
    "no-projection-loads": ("(i) the step's xp loads", [
        ("row < n ? load2(xr + q * H + u0 + 8 * s + 2 * tq) : 0u", "uint32_t(q + s)")]),
    "no-gate-math": ("(iii) the exact expf, division and tanhf", [
        ("return rnd(1.0f / rnd(rnd(expf(-z)) + 1.0f));", "return rnd(0.25f * z + 0.5f);"),
        ("tanhf(", "0.5f * (")]),
    "no-products": ("(ii) the mma.sync products", [
        ("mma_bf16(part, a, bw[t8][kt][0], bw[t8][kt][1]);",
         "part[0] = __uint_as_float(a[0] ^ bw[t8][kt][0]); "
         "part[1] = __uint_as_float(a[1] ^ bw[t8][kt][1]);")]),
    "no-output-stores": ("(iv) the y stores", [
        ("if (row < n) {\n          *reinterpret_cast<uint32_t*>(y",
         "if (row < 0) {\n          *reinterpret_cast<uint32_t*>(y")]),
    "no-barrier": ("(v) the step's __syncthreads", [
        ("    __syncthreads();\n    buf ^= 1;", "    buf ^= 1;")]),
}


# The backward's step with one part taken out, on the source given to
# --backward-variants (an earlier form) and on this checkout's: each variant's
# replacements are made where their text is there (at least one must be);
# a variant none of whose text is in a source is skipped for it.
BACKWARD_VARIANTS = {
    "as-is": ("nothing", []),
    "no-products": ("the step's dz . W_hh products", [
        ("      mma_bf16(part, a, bw[kt][0], bw[kt][1]);",
         "      part[0] = __uint_as_float(a[0] ^ bw[kt][0]); "
         "part[1] = __uint_as_float(a[1] ^ bw[kt][1]);")]),
    "half-products": ("half the product's k tiles (a chain of 16, not 32)", [
        ("    for (int kt = 0; kt < KT; ++kt) {\n      uint32_t a[4];\n      load_a(a, tile, ZLD",
         "    for (int kt = 0; kt < KT / 2; ++kt) {\n      uint32_t a[4];\n      load_a(a, tile, ZLD"),
        ("    for (int kt = 0; kt < KT; ++kt) {\n      uint32_t a[4];\n      const int k = kt",
         "    for (int kt = 0; kt < KT / 2; ++kt) {\n      uint32_t a[4];\n      const int k = kt"),
        ("    for (int i = 0; i < KH; ++i) {\n      const int k = (kh * KH + i)",
         "    for (int i = 0; i < KH / 2; ++i) {\n      const int k = (kh * KH + i)")]),
    "no-pair-sum": ("the warp pair's exchange of its two sums (the named barrier)", [
        ("    asm volatile(\"bar.sync %0, 64;\\n\" ::\"r\"(1 + ug));", "")]),
    "no-prev-c-load": ("the previous step's c, loaded from device memory on the chain", [
        ("step > 0 ? load2(c + (int64_t(row) * k_len + tp) * ys + int64_t(d) * H + u)",
         "step > 0 ? uint32_t(step)")]),
    "no-barrier": ("the step's __syncthreads", [
        ("    cp_async_wait<kStages - 2>();  // the next step's tiles\n    __syncthreads();",
         "    cp_async_wait<kStages - 2>();  // the next step's tiles"),
        ("    cp_async_wait<kStages - 3>();  // the next step's tiles and the c after them\n"
         "    __syncthreads();",
         "    cp_async_wait<kStages - 3>();  // the next step's tiles and the c after them")]),
    "no-gate-lookups": ("the tables' loads (every gate 0.5)", [
        ("  return from_bits(table[outside ? 0u : ((((b >> 15) * kExps + e) << 7) | (b & 0x7fu))]);",
         "  outside = false;\n  return 0.5f + 0.0f * z;")]),
}
TRAIN_ROWS, STEPS = 516, 250  # SkiM's B=2 x 4 s training step: 516 rows of 250 steps

# The training forward's step with one part taken out, on the source given
# to --train-variants and on this checkout's, as BACKWARD_VARIANTS is read.
TRAIN_VARIANTS = {
    "as-is": ("nothing", []),
    "no-kept-stores": ("the kept gates' and cells' stores", [
        ("      if (TRAIN && row < n) {", "      if (TRAIN && row < 0) {"),
        ("    if (kstore) {  // the kept gates", "    if (false) {  // the kept gates"),
        ("    if (cstore) {  // the kept cells", "    if (false) {  // the kept cells")]),
    "no-output-stores": ("the y stores", [
        ("    if (step > 0) store_h(hb, rev ? t + 1 : t - 1);",
         "    if (step < 0) store_h(hb, rev ? t + 1 : t - 1);"),
        ("    if (ystore) {  // y", "    if (false) {  // y")]),
    "no-gate-lookups": NEW_VARIANTS["no-gate-lookups"],
    "no-products": ("the mma.sync products", [
        ("        mma_bf16(part, a, bw[q][kt][0], bw[q][kt][1]);",
         "        part[0] = __uint_as_float(a[0] ^ bw[q][kt][0]); "
         "part[1] = __uint_as_float(a[1] ^ bw[q][kt][1]);"),
        ("        mma_bf16(part, wa[q][i], b0, b1);",
         "        part[0] = __uint_as_float(wa[q][i][0] ^ b0); "
         "part[1] = __uint_as_float(wa[q][i][1] ^ b1);")]),
    "no-pair-sum": ("the warp pair's exchange of its two halves (the named barrier)", [
        ("    asm volatile(\"bar.sync %0, 64;\\n\" ::\"r\"(1 + ug));  // the pair's halves", "")]),
    "no-barrier": ("the step's __syncthreads", [
        ("    cp_async_wait<kStages - 2>();  // the next step's tile\n    __syncthreads();",
         "    cp_async_wait<kStages - 2>();  // the next step's tile"),
        ("    cp_async_wait<kStages - 2>();  // the next step's tile and outputs\n"
         "    __syncthreads();",
         "    cp_async_wait<kStages - 2>();  // the next step's tile and outputs")]),
}


def _build_variants(todo: dict) -> dict:
    """Each ``name: (source text, (what, [(text, replacement)]))`` built by
    ``nvcc`` with the replacements made; ``{name: .so}``."""
    import hashlib
    import os
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from sonicsim_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(name):
        src, (_, subs) = todo[name]
        for old, new in subs:
            src = src.replace(old, new)
        key = hashlib.sha256(src.encode()).hexdigest()[:12]
        cu = kernels.BUILD_DIR / f"probe_{name.replace(' ', '_')}_{key}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src)
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{r.stderr}")
        return so

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return dict(zip(todo, pool.map(build, todo)))


def backward_variants(source: Path) -> None:
    """The module docstring's ``--backward-variants``."""
    import ctypes

    todo, libs = _variant_builds(source, BACKWARD_VARIANTS)
    dev = torch.device("cuda")
    smi = _card_line()
    stream = torch.cuda.current_stream().cuda_stream
    p = ctypes.c_void_p
    sigs = [p] * 10 + [ctypes.c_int64] * 5 + [ctypes.c_int, p]
    inputs = {}
    for rows in (TRAIN_ROWS, 2 * TRAIN_ROWS):
        rng = np.random.default_rng(rows)

        def bf(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

        xp = bf(rng.standard_normal((rows, STEPS, DIRS * 4 * H)))
        w_hh = bf(rng.standard_normal((DIRS, 4 * H, H)) / np.sqrt(H))
        bias = bf(0.1 * rng.standard_normal((DIRS, 4 * H)))
        zeros = bf(np.zeros((DIRS, rows, H)))
        dy = bf(rng.standard_normal((rows, STEPS, DIRS * H)))
        inputs[rows] = (xp, w_hh, bias, zeros, dy)
    # Each source's backward reads what that source's training forward kept.
    kept = {}
    for label in ("given", "this"):
        fwd = ctypes.CDLL(str(libs[f"{label} as-is"])).sonicsim_bf16_lstm_scan
        fwd.argtypes = sigs
        for rows, (xp, w_hh, bias, zeros, dy) in inputs.items():
            y = torch.empty(rows, STEPS, DIRS * H, dtype=torch.bfloat16, device=dev)
            hn, cn = torch.empty_like(zeros), torch.empty_like(zeros)
            zk, ck = torch.empty_like(xp), torch.empty_like(y)
            fwd(*[t.data_ptr() for t in (xp, w_hh, bias, zeros, zeros, y, hn, cn, zk, ck)],
                rows, STEPS, DIRS, H, 2, 0, stream)
            dz = torch.empty_like(xp)
            dh0, dc0 = torch.empty_like(zeros), torch.empty_like(zeros)
            kept[label, rows] = [dy, zeros, zeros, zk, ck, w_hh, zeros, dz, dh0, dc0]
    torch.cuda.synchronize()
    times = {}
    for turn in range(2):  # in turns: every variant twice
        for name, so in libs.items():
            fn = ctypes.CDLL(str(so)).sonicsim_bf16_lstm_scan_backward
            fn.argtypes = sigs
            for rows in inputs:
                if rows != TRAIN_ROWS and not name.endswith("as-is"):
                    continue
                args = [t.data_ptr() for t in kept[name.split()[0], rows]] + [
                    rows, STEPS, DIRS, H, 2, 0, stream]
                times.setdefault((name, rows), []).append(median_ms(lambda: fn(*args)))
    for (name, rows), ms in times.items():
        print(json.dumps({"backward variant": name, "rows": rows,
                          "takes out": todo[name][1][0], "ms": ms,
                          "source": str(source) if name.startswith("given") else "this checkout",
                          "card": smi}), flush=True)
    xp, w_hh, bias, zeros, dy = inputs[TRAIN_ROWS]
    backward_readings(dy, xp, w_hh, bias, zeros, dev)


def _variant_builds(source: Path, variants: dict) -> tuple:
    """``{label name: (text, (what, replacements))}`` for ``source`` (label
    "given") and this checkout's ``bf16_lstm.cu`` ("this"), each variant
    with the replacements whose text is in that source (one at least, but
    for "as-is"), and what ``nvcc`` built of them."""
    todo = {}
    for label, text in (("given", source.read_text()), ("this", lstm_cell.SOURCE.read_text())):
        for n, (what, subs) in variants.items():
            found = [(a, b) for a, b in subs if a in text]
            if found or not subs:
                todo[f"{label} {n}"] = (text, (what, found))
    return todo, _build_variants(todo)


def _card_line() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def train_variants(source: Path) -> None:
    """The module docstring's ``--train-variants``."""
    import ctypes

    todo, libs = _variant_builds(source, TRAIN_VARIANTS)
    dev = torch.device("cuda")
    smi = _card_line()
    stream = torch.cuda.current_stream().cuda_stream
    p = ctypes.c_void_p
    sigs = [p] * 10 + [ctypes.c_int64] * 5 + [ctypes.c_int, p]
    buffers = {}
    for rows in (TRAIN_ROWS, 2 * TRAIN_ROWS):
        rng = np.random.default_rng(rows)

        def bf(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

        xp = bf(rng.standard_normal((rows, STEPS, DIRS * 4 * H)))
        w_hh = bf(rng.standard_normal((DIRS, 4 * H, H)) / np.sqrt(H))
        bias = bf(0.1 * rng.standard_normal((DIRS, 4 * H)))
        zeros = bf(np.zeros((DIRS, rows, H)))
        y = torch.empty(rows, STEPS, DIRS * H, dtype=torch.bfloat16, device=dev)
        buffers[rows] = [xp, w_hh, bias, zeros, zeros, y, torch.empty_like(zeros),
                         torch.empty_like(zeros), torch.empty_like(xp), torch.empty_like(y)]
    times = {}
    for turn in range(2):  # in turns: every variant twice
        for name, so in libs.items():
            fn = ctypes.CDLL(str(so)).sonicsim_bf16_lstm_scan
            fn.argtypes = sigs
            for rows, bufs in buffers.items():
                if rows != TRAIN_ROWS and not name.endswith("as-is"):
                    continue
                args = [t.data_ptr() for t in bufs] + [rows, STEPS, DIRS, H, 2, 0, stream]
                times.setdefault((name, rows), []).append(median_ms(lambda: fn(*args)))
    for (name, rows), ms in times.items():
        print(json.dumps({"training forward variant": name, "rows": rows,
                          "takes out": todo[name][1][0], "ms": ms,
                          "source": str(source) if name.startswith("given") else "this checkout",
                          "card": smi}), flush=True)
    # The serving forward's outputs on the card tests' seeded inputs, by each
    # source: tests/test_torch_bf16_cell_cuda.py's SERVING_SHA256.
    from test_torch_bf16_cell_cuda import serving_digest

    for label in ("given", "this"):
        lib = ctypes.CDLL(str(libs[f"{label} as-is"]))
        lib.sonicsim_bf16_lstm_scan.argtypes = sigs
        lstm_cell._lib = lib
        print(json.dumps({"serving forward sha256": serving_digest(dev),
                          "source": str(source) if label == "given" else "this checkout",
                          "card": smi}), flush=True)
    lstm_cell._lib = None
    xp, w_hh, bias, zeros = buffers[TRAIN_ROWS][:4]
    reverse = [False, True]
    got = lstm_cell.bf16_lstm_scan(xp, w_hh, bias, zeros, zeros, reverse, keep=True)
    want = lstm_cell.bf16_lstm_scan_ref(xp, w_hh, bias, zeros, zeros, reverse, keep=True)
    print(json.dumps({"rows": TRAIN_ROWS, "training forward": "kernel vs plain",
                      **{k: rel(a, b) for k, a, b in zip(("y", "hn", "cn", "gates", "c"),
                                                          got, want)},
                      "bit_equal": [float((a == b).float().mean()) for a, b in zip(got, want)],
                      "card": smi}), flush=True)


def backward_readings(dy, xp, w_hh, bias, h0, dev) -> None:
    """This checkout's backward (on its training forward's gates and c),
    its plain version and the plain version with an exact dot, each against
    the others: one JSON line a pair."""
    reverse = [False, True]
    _, _, _, gates, c = lstm_cell.bf16_lstm_scan(xp, w_hh, bias, h0, h0, reverse, keep=True)
    g = torch.Generator(device=dev).manual_seed(3)
    dhn, dcn = (torch.randn(h0.shape, generator=g, device=dev).bfloat16() for _ in range(2))
    bargs = (dy, dhn, dcn, gates, c, w_hh, h0, reverse)
    outs = {"kernel": lstm_cell.bf16_lstm_scan_backward(*bargs),
            "plain": lstm_cell.bf16_lstm_scan_backward_ref(*bargs),
            "plain_f64_dot": plain_backward_f64_dot(*bargs)}
    for a, b in (("kernel", "plain"), ("kernel", "plain_f64_dot"), ("plain", "plain_f64_dot")):
        u, v = outs[a], outs[b]
        print(json.dumps({"rows": xp.shape[0], "backward": f"{a} vs {b}", "dz": rel(u[0], v[0]),
                          "dh0": rel(u[1], v[1]), "dc0": rel(u[2], v[2]),
                          "flipped": [float((p != q).float().mean()) for p, q in zip(u, v)]}),
              flush=True)


def variants(source: Path) -> None:
    """The module docstring's ``--variants``."""
    import ctypes

    todo = {f"given {n}": (source.read_text(), VARIANTS[n]) for n in VARIANTS}
    todo.update({f"this {n}": (lstm_cell.SOURCE.read_text(), NEW_VARIANTS[n])
                 for n in NEW_VARIANTS})
    for name, (src, (_, subs)) in todo.items():
        for old, _ in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in its source")
    libs = _build_variants(todo)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    xp = bf(rng.standard_normal((N, 250, DIRS * 4 * H)))
    w_hh = bf(rng.standard_normal((DIRS, 4 * H, H)) / np.sqrt(H))
    bias = bf(0.1 * rng.standard_normal((DIRS, 4 * H)))
    h0 = c0 = bf(np.zeros((DIRS, N, H)))
    y = torch.empty(N, 250, DIRS * H, dtype=torch.bfloat16, device=dev)
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream().cuda_stream
    smi = _card_line()
    times = {}
    for turn in range(2):  # in turns: every variant twice
        for name, so in libs.items():
            fn = ctypes.CDLL(str(so)).sonicsim_bf16_lstm_scan
            new = name.startswith("this")  # two more pointers: z_out, c_out (null)
            fn.argtypes = [ctypes.c_void_p] * (10 if new else 8) + [ctypes.c_int64] * 5 + [
                ctypes.c_int, ctypes.c_void_p]
            args = [t.data_ptr() for t in (xp, w_hh, bias, h0, c0, y, hn, cn)] + (
                [None, None] if new else []) + [N, 250, DIRS, H, 2, 0, stream]
            times.setdefault(name, []).append(median_ms(lambda: fn(*args)))
    for name, ms in times.items():
        print(json.dumps({"variant": name, "takes out": todo[name][1][0], "ms": ms,
                          "source": str(source) if name.startswith("given") else "this checkout",
                          "card": smi}), flush=True)
    # This checkout's kernels at the same shape.
    reverse = [False, True]
    args = (xp, w_hh, bias, h0, c0, reverse)
    y, hn, cn, gates, c = lstm_cell.bf16_lstm_scan(*args, keep=True)
    dy = torch.randn(y.shape, device=dev).bfloat16()
    zero = torch.zeros_like(h0)
    dz, _, _ = lstm_cell.bf16_lstm_scan_backward(dy, zero, zero, gates, c, w_hh, c0, reverse)
    x = bf(rng.standard_normal((N, 250, 64)))
    prods = lstm_cell.step_products(dz, x, y, h0, reverse)
    backward_readings(dy, xp, w_hh, bias, h0, dev)
    print(json.dumps({
        "forward_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan(*args)),
        "training_forward_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan(*args, keep=True)),
        "backward_ms": median_ms(lambda: lstm_cell.bf16_lstm_scan_backward(
            dy, zero, zero, gates, c, w_hh, c0, reverse)),
        "step_products_ms": median_ms(lambda: lstm_cell.step_products(dz, x, y, h0, reverse)),
        "running_sum_ms": median_ms(lambda: lstm_cell.bf16_running_sum(prods, dz, reverse)),
        "card": smi}), flush=True)


if __name__ == "__main__":
    if "--train-variants" in sys.argv:
        train_variants(Path(sys.argv[sys.argv.index("--train-variants") + 1]))
    elif "--backward-variants" in sys.argv:
        backward_variants(Path(sys.argv[sys.argv.index("--backward-variants") + 1]))
    elif "--variants" in sys.argv:
        variants(Path(sys.argv[sys.argv.index("--variants") + 1]))
    else:
        main()
