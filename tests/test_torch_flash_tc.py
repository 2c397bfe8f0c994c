"""The bf16 tensor-core route of ``flash_attention``, on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda_kernels.py``).
Here: its error budget, by a test-local copy of its arithmetic (bf16
inputs, f32 logits scaled after the product, the online softmax over 64-key
tiles in the log2 domain, P rounded to bf16 before the P V product, one
division by l and one rounding to bf16 at the end) held to
``attention_tolerance(bf16)`` against ``chunked_attention`` and the JAX
package's ``chunked_attention``; and the routing rule at the head dims of
the models and cases and at the edges of the tensor-core route.  Inputs
are made with numpy from a seed."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ops as jops
from repro_torch.kernels import checks
from repro_torch.kernels import flash_attention as fa

TILE = 64
LOG2E = np.float32(1.4426950408889634)
BUDGET_CASES = ("qwen-384", "danube-gqa-window", "masked-rows")


def _inputs(name: str, seed: int = 0):
    c = checks.ATTENTION_CASES[name]
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(torch.bfloat16)
    q = rand(c["b"], c["hq"], c["sq"], c["d"])
    k = rand(c["b"], c["hkv"], c["skv"], c["d"])
    v = rand(c["b"], c["hkv"], c["skv"], c["dv"])
    kw = dict(causal=c.get("causal", True), window=c.get("window"),
              q_offset=c.get("q_offset", 0))
    return q, k, v, kw


def tensor_core_arithmetic(q, k, v, *, causal, window, q_offset):
    """The tensor-core kernel's arithmetic in PyTorch (module docstring)."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    scale2 = torch.tensor(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    masked2 = torch.tensor(np.float32(fa.NEG_INF) * LOG2E)
    qpos = torch.arange(sq) + q_offset
    m = torch.full((b, hq, sq, 1), float(masked2))
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, dv))
    for k0 in range(0, skv, TILE):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kf[:, :, k0:k0 + TILE]) * scale2
        kpos = torch.arange(k0, min(k0 + TILE, skv))
        seen = torch.ones((sq, kpos.numel()), dtype=torch.bool)
        if causal:
            seen &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            seen &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(seen, s, masked2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + TILE])
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("name", BUDGET_CASES)
def test_bf16_p_rounding_stays_within_the_bf16_tolerance(name):
    q, k, v, kw = _inputs(name)
    got = tensor_core_arithmetic(q, k, v, **kw)
    rtol, atol = checks.attention_tolerance(torch.bfloat16)
    checks.close(name, got, fa.chunked_attention(q, k, v, **kw), rtol, atol)
    want = np.array(jops.chunked_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), **kw))
    checks.close(f"{name} vs the JAX package", got, torch.from_numpy(want),
                 rtol, atol)


def test_fully_masked_rows_keep_the_mean_of_v_in_bf16():
    """Every row of ``masked-rows`` sees no key: the -1e30 logit makes each
    the mean of V over all keys, in the kernel's arithmetic too."""
    q, k, v, kw = _inputs("masked-rows")
    got = tensor_core_arithmetic(q, k, v, **kw).float()
    mean = v.float().mean(2, keepdim=True).repeat_interleave(2, dim=1)
    checks.close("masked-rows mean", got, mean.expand_as(got),
                 *checks.attention_tolerance(torch.bfloat16))


@pytest.mark.parametrize("dtype,d,dv,want", [
    # bf16 at the ported models' head dims and the cases' (qwen, danube,
    # ragged-noncausal), and at the edges of the tensor-core route
    (torch.bfloat16, 64, 64, "tensor_core"),
    (torch.bfloat16, 80, 80, "tensor_core"),
    (torch.bfloat16, 32, 48, "tensor_core"),
    (torch.bfloat16, 8, 8, "tensor_core"),
    (torch.bfloat16, 128, 128, "tensor_core"),
    (torch.bfloat16, 128, 8, "tensor_core"),
    (torch.bfloat16, 136, 64, "cuda_core"),
    (torch.bfloat16, 64, 136, "cuda_core"),
    (torch.bfloat16, 192, 128, "cuda_core"),
    (torch.bfloat16, 256, 256, "cuda_core"),
    (torch.bfloat16, 60, 64, "cuda_core"),
    (torch.bfloat16, 64, 100, "cuda_core"),
    (torch.bfloat16, 1, 1, "cuda_core"),
    # float32 never takes the tensor cores
    (torch.float32, 64, 64, "cuda_core"),
    (torch.float32, 80, 80, "cuda_core"),
    (torch.float32, 8, 8, "cuda_core"),
    (torch.float32, 128, 128, "cuda_core"),
    (torch.float32, 192, 128, "cuda_core"),
])
def test_route_by_dtype_and_head_dims(dtype, d, dv, want):
    assert fa.route(dtype, d, dv) == want


@pytest.mark.parametrize("name", sorted(checks.ATTENTION_CASES))
def test_route_of_each_attention_case(name):
    assert checks.attention_route(name, torch.float32) == "cuda_core"
    want = "cuda_core" if name in checks.HEAD_DIM_OVER_128 \
        else "tensor_core"
    assert checks.attention_route(name, torch.bfloat16) == want


@pytest.mark.parametrize("dtype,d,dv,err", [
    (torch.float16, 64, 64, TypeError),
    (torch.int8, 64, 64, TypeError),
    (torch.bfloat16, 0, 64, ValueError),
    (torch.bfloat16, 64, 257, ValueError),
])
def test_route_refuses_what_no_kernel_takes(dtype, d, dv, err):
    with pytest.raises(err):
        fa.route(dtype, d, dv)



@pytest.mark.parametrize("name", sorted(checks.ATTENTION_CASES))
def test_visible_pairs_count_the_kernels_mask(name):
    """``chip_smoke.visible_pairs`` (the operations of an attention bound)
    counts the keys each query row sees under the kernels' mask: causal,
    window and q_offset as ``chunked_attention`` applies them."""
    c = checks.ATTENTION_CASES[name]
    kw = checks.attention_kw(c)
    qpos = torch.arange(c["sq"])[:, None] + kw["q_offset"]
    kpos = torch.arange(c["skv"])[None, :]
    seen = torch.ones((c["sq"], c["skv"]), dtype=torch.bool)
    if kw["causal"]:
        seen &= kpos <= qpos
    if kw["window"] is not None:
        seen &= kpos > qpos - kw["window"]
    assert chip_smoke.visible_pairs(c["sq"], c["skv"], **kw) == \
        int(seen.sum())
