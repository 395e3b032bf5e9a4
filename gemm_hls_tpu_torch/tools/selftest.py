"""Hardware self-test: one command that checks the port's compute surface
on the card against the host oracle; the port of
``gemm_hls_tpu/tools/selftest.py``.

    python -m gemm_hls_tpu_torch.tools.selftest [--quick] [--device {cuda,cpu}]

The hardware counterpart of the CPU test suite, the analogue of running
``RunHardware.exe ... on`` across the supported configuration space
(reference ``host/RunHardware.cpp:199-227``): every dtype / semiring /
shape class runs end to end on the card's kernels (B1-B5, B6-B12, B13,
B16-B18) and is compared with the float64 / exact host oracle.  ``--quick``
uses 256^3 in place of the 1024^3 checks; ``--device cpu`` runs the plain
versions at the quick sizes.  A check that fails or raises is reported as
FAIL / ERROR and makes the exit code non-zero.

Where the reference's check names a TPU-only knob, the port keeps the
check's shape and data: the unaligned multi-K-step case runs the card's
compiled tile (not 256-blocks), the fused epilogue checks use the
registered ``bias_relu`` (a Python callable runs on CPU tensors only), and
the degenerate ring is the port's ``ring_matmul`` on a one-rank mesh.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch


def _normwise(got, a, b) -> float:
    exp = a @ b
    return float((np.abs(got - exp) / (np.linalg.norm(a, axis=1)[:, None]
                                       * np.linalg.norm(b, axis=0)[None, :])).max())


def _scaled_err(got, ref, floor: float) -> float:
    """Max of |got - ref| / max(floor * max|ref|, |ref|)."""
    return float((np.abs(got - ref) / np.maximum(np.abs(ref).max() * floor,
                                                 np.abs(ref))).max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="smaller shapes (skip the 1024^3 checks)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the checks run (cpu: the plain versions, "
                        "at the quick sizes)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("selftest: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return 2

    from gemm_hls_tpu_torch import GemmConfig, matmul
    from gemm_hls_tpu_torch.config import torch_dtype
    from gemm_hls_tpu_torch.utils.verify import (
        check_result, make_operands, reference_matmul, tolerance_for,
    )

    dev = torch.device(args.device)
    big = 256 if args.quick or dev.type == "cpu" else 1024
    results = []

    def on(x, dtype=None):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    def host(t) -> np.ndarray:
        """A tensor as float64 / int64 / bool numpy (bf16 / fp16 exactly)."""
        t = t.detach().cpu()
        if t.is_floating_point():
            return t.double().numpy()
        return t.numpy()

    def check(name, fn):
        t0 = time.perf_counter()
        try:
            ok, err = fn()
            status = "PASS" if ok else "FAIL"
        except Exception as e:  # noqa: BLE001 (reported as a failure)
            traceback.print_exc()
            ok, err, status = False, None, f"ERROR ({type(e).__name__}: {e})"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        detail = f" maxerr={err:.2e}" if isinstance(err, float) else ""
        print(f"[{status}] {name}{detail} ({dt:.1f}s)", flush=True)
        results.append(ok)

    def gemm_case(m, n, k, dtype, semiring="plus_times", rtol=None, **kw):
        def run():
            a, b = make_operands(m, n, k, dtype)
            at, bt = on(a, torch_dtype(dtype)), on(b, torch_dtype(dtype))
            out = matmul(at, bt, semiring=semiring, **kw)
            exp = reference_matmul(host(at), host(bt), semiring=semiring)
            return check_result(host(out), exp,
                                rtol=tolerance_for(out.dtype) if rtol is None else rtol)
        return run

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"selftest on {name} ({args.device}), "
          f"devices={torch.cuda.device_count() if dev.type == 'cuda' else 1}")

    check(f"fp32 {big}^3 (1e-3 regime)", gemm_case(big, big, big, "float32"))
    check(f"bf16 {big}^3 fp32-acc",
          gemm_case(big, big, big, "bfloat16", rtol=1e-2, out_dtype="float32"))
    check("unaligned 333x517x129 fp32", gemm_case(333, 517, 129, "float32"))
    # The K tail across several K steps plus M / N edge masking, bf16.
    check("unaligned bf16 multi-K-step (k_rem)",
          gemm_case(515, 389, 777, "bfloat16", rtol=1e-2, out_dtype="float32"))
    check("int8 -> int32", gemm_case(256, 256, 512, "int8", out_dtype="int32"))
    check("min_plus (distance product)",
          gemm_case(256, 512, 300, "float32", semiring="min_plus"))
    check("max_min (widest path)",
          gemm_case(128, 256, 200, "float32", semiring="max_min"))
    check("or_and bool reachability (tensor-core counting)",
          gemm_case(64, 128, 96, "bool", semiring="or_and"))
    check("or_and bit-packed (backend=vpu)",
          gemm_case(64, 128, 97, "bool", semiring="or_and", backend="vpu"))

    def grad_check():
        a, b = make_operands(64, 128, 96, "float32")
        at = on(a).requires_grad_()
        ga, = torch.autograd.grad(matmul(at, on(b)).pow(2).sum(), at)
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        return check_result(host(ga), 2.0 * (a64 @ b64) @ b64.T, rtol=1e-3)
    check("autograd gradient", grad_check)

    def ozaki_check():
        from gemm_hls_tpu_torch.ops.ozaki import ozaki_matmul
        rng = np.random.default_rng(5)
        a = rng.uniform(-5, 5, (128, 256))
        b = rng.uniform(-5, 5, (256, 128))
        normw = _normwise(ozaki_matmul(a, b, device=dev), a, b)
        return normw < 1e-13, normw
    check("f64-class Ozaki (normwise < 1e-13)", ozaki_check)

    def ozaki_fused_int8_check():
        from gemm_hls_tpu_torch.ops.ozaki import ozaki_matmul_int8
        rng = np.random.default_rng(6)
        a = rng.uniform(-5, 5, (160, 300))
        b = rng.uniform(-5, 5, (300, 140))
        normw = _normwise(ozaki_matmul_int8(a, b, device=dev), a, b)
        return normw < 1e-13, normw
    check("f64-class fused Ozaki-int8 (normwise < 1e-13)",
          ozaki_fused_int8_check)

    def int8_slices_check():
        from gemm_hls_tpu_torch.ops.int8_slices import fp32_matmul_int8
        a, b = make_operands(256, 256, 512, "float32", low=-5.0, high=5.0)
        got = host(fp32_matmul_int8(on(a), on(b), block_m=256, block_n=256,
                                    block_k=512, n_slices=3))
        normw = _normwise(got, a.astype(np.float64), b.astype(np.float64))
        return normw < 2e-6, normw
    check("fp32 via int8 slices (normwise < 2e-6)", int8_slices_check)

    def ring_kernel_check():
        # A one-rank ring: no block crosses ranks, but the kernel's rank
        # table, flags and tiles run.
        from gemm_hls_tpu_torch.parallel import make_mesh, ring_matmul
        mesh = make_mesh((1,), ("x",), devices=[dev])
        a, b = make_operands(64, 128, 256, "float32")
        exp = reference_matmul(a, b)
        ok1, e1 = check_result(host(torch.cat(ring_matmul(on(a), on(b), mesh))),
                               exp, rtol=1e-3)
        ok2, e2 = check_result(host(torch.cat(ring_matmul(on(a), on(b), mesh,
                                                          block_k=128))),
                               exp, rtol=1e-3)
        return ok1 and ok2, max(e1, e2)
    check("fused ring kernel (one-rank ring)", ring_kernel_check)

    def fused_linear_grad_check():
        from gemm_hls_tpu_torch.ops.fused_linear import fused_linear
        x, w = make_operands(64, 128, 96, "float32", low=-1.0, high=1.0)
        bias = np.linspace(-0.5, 0.5, 128).astype(np.float32)
        wt = on(w).requires_grad_()
        gw, = torch.autograd.grad(
            fused_linear(on(x), wt, on(bias), "relu").pow(2).sum(), wt)
        w64 = torch.from_numpy(w).double().requires_grad_()
        rw, = torch.autograd.grad(torch.relu(
            torch.from_numpy(x).double() @ w64
            + torch.from_numpy(bias).double()).pow(2).sum(), w64)
        err = _scaled_err(host(gw), rw.numpy(), 1e-2)
        return err < 1e-3, err
    check("fused linear gradient", fused_linear_grad_check)

    def epilogue_check():
        a, b = make_operands(64, 128, 96, "float32", low=-3.0, high=3.0)
        bias = np.linspace(-2, 2, 128).astype(np.float32)
        out = matmul(on(a), on(b), epilogue="bias_relu",
                     epilogue_operands=(on(bias),))
        exp = np.maximum(a.astype(np.float64) @ b + bias, 0.0)
        # Scale-aware: outputs at the ReLU kink make element-wise relative
        # error meaningless.
        err = float((np.abs(host(out) - exp) / np.maximum(np.abs(exp), 1.0)).max())
        return err < 1e-3, err
    check("fused bias+relu epilogue", epilogue_check)

    def batched_epilogue_grad_check():
        rng = np.random.default_rng(7)
        a = rng.uniform(-1, 1, (8, 128, 64)).astype(np.float32)
        b = rng.uniform(-1, 1, (8, 64, 128)).astype(np.float32)
        bias = np.linspace(-0.5, 0.5, 128).astype(np.float32)
        at = on(a).requires_grad_()
        ga, = torch.autograd.grad(matmul(
            at, on(b), epilogue="bias_relu",
            epilogue_operands=(on(bias),)).pow(2).sum(), at)
        a64 = torch.from_numpy(a).double().requires_grad_()
        ra, = torch.autograd.grad(torch.relu(
            a64 @ torch.from_numpy(b).double()
            + torch.from_numpy(bias).double()).pow(2).sum(), a64)
        err = _scaled_err(host(ga), ra.numpy(), 1e-2)
        return err < 1e-3, err
    check("batched fused-epilogue gradient", batched_epilogue_grad_check)

    def batched_bf16_grad_check():
        # bf16 batched backward: the cotangent arrives fp32 against bf16
        # saved operands.
        rng = np.random.default_rng(8)
        a = on(rng.uniform(-1, 1, (8, 128, 64)), torch.bfloat16).requires_grad_()
        b = on(rng.uniform(-1, 1, (8, 64, 128)), torch.bfloat16)
        ga, = torch.autograd.grad(matmul(a, b, out_dtype="float32").pow(2).sum(), a)
        a64 = torch.from_numpy(host(a)).requires_grad_()
        ra, = torch.autograd.grad(
            (a64 @ torch.from_numpy(host(b))).pow(2).sum(), a64)
        err = _scaled_err(host(ga), ra.numpy(), 1e-1)
        return err < 5e-2, err
    check("bf16 batched gradient (mixed-dtype backward)", batched_bf16_grad_check)

    def flash_attention_check():
        # Causal GQA (4 q heads on 2 kv heads) over a streamed kv, the
        # forward against the float64 oracle and a finite dq.
        from gemm_hls_tpu_torch.ops.attention import flash_attention
        rng = np.random.default_rng(11)
        hq, hkv, s, d = 4, 2, 384, 128
        q = rng.standard_normal((hq, s, d)).astype(np.float32)
        k = rng.standard_normal((hkv, s, d)).astype(np.float32)
        v = rng.standard_normal((hkv, s, d)).astype(np.float32)
        qt = on(q).requires_grad_()
        out = flash_attention(qt, on(k), on(v), causal=True, block_q=128,
                              block_kv=128)
        q64 = q.astype(np.float64)
        k64 = np.repeat(k.astype(np.float64), hq // hkv, axis=0)
        v64 = np.repeat(v.astype(np.float64), hq // hkv, axis=0)
        sc = q64 @ k64.transpose(0, 2, 1) / np.sqrt(d)
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
        e = np.exp(sc - sc.max(-1, keepdims=True))
        exp = (e / e.sum(-1, keepdims=True)) @ v64
        err = float(np.abs(host(out) - exp).max() / np.abs(exp).max())
        dq, = torch.autograd.grad(out.pow(2).sum(), qt)
        return err < 5e-3 and bool(torch.isfinite(dq).all()), err
    check("flash attention (causal GQA, streamed kv) + grad",
          flash_attention_check)

    def quantized_matmul_check():
        # Weight-only quantized GEMM (int8 per-channel, planar int4
        # group-wise) against the host dequant oracle.
        from gemm_hls_tpu_torch.ops.quant import (
            dequantize_weights, matmul_quantized, quantize_weights,
        )
        rng = np.random.default_rng(13)
        w = (rng.standard_normal((512, 256)) / 16).astype(np.float32)
        x = on(rng.standard_normal((32, 512)), torch.bfloat16)
        worst = 0.0
        for bits, g in ((8, None), (4, 128)):
            wq, s = quantize_weights(w, bits=bits, group_size=g)
            got = host(matmul_quantized(x, wq, s, bits=bits, group_size=g,
                                        out_dtype="float32"))
            ref = host(x) @ dequantize_weights(wq, s, bits=bits, group_size=g)
            worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
        # bf16 activations bound the kernel-vs-host agreement at ~1e-2.
        return worst < 2e-2, worst
    check("quantized GEMM (int8 + int4 fused dequant)", quantized_matmul_check)

    def grouped_matmul_check():
        # Ragged MoE expert GEMM over a row partition (an empty group,
        # unaligned boundaries, a tail) against per-group host products,
        # and finite gradients.
        from gemm_hls_tpu_torch.ops.grouped import grouped_matmul
        rng = np.random.default_rng(17)
        m, k, n, groups = 512, 256, 256, 4
        gs = [150, 0, 299, 50]
        lhs = on(rng.uniform(-1, 1, (m, k)), torch.bfloat16).requires_grad_()
        rhs = on(rng.uniform(-1, 1, (groups, k, n)), torch.bfloat16).requires_grad_()
        cfg = GemmConfig(dtype="bfloat16", out_dtype="float32")
        gsa = on(np.asarray(gs, np.int32))
        out = grouped_matmul(lhs, rhs, gsa, cfg)
        got = host(out)
        ref = np.zeros_like(got)
        lh, rh = host(lhs), host(rhs)
        s = 0
        for g, sz in enumerate(gs):
            ref[s:s + sz] = lh[s:s + sz] @ rh[g]
            s += sz
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        if not (err < 2e-2 and np.all(got[sum(gs):] == 0)):
            return False, err
        gl, gr = torch.autograd.grad(out.pow(2).sum(), (lhs, rhs))
        ok = bool(torch.isfinite(gl.float()).all() and torch.isfinite(gr.float()).all()
                  and gr[1].float().abs().max() == 0)
        return ok, err
    check("grouped MoE GEMM (ragged partition + grad)", grouped_matmul_check)

    n_pass = sum(results)
    print(f"{n_pass}/{len(results)} checks passed")
    return 0 if n_pass == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
