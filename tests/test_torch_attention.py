"""The port's attention over the KV cache held against the JAX package's,
teacher-forced, one layer at a time.

Both packages' ``llama.attention`` receive the same q/k/v rows (each
package's ``project_qkv`` is replaced by one returning fixed rows, so no Q80
or bf16 re-rounding of the projections intervenes) and the same pre-filled
cache, whose slots past the query positions hold garbage the causal mask
must hide. Cases cover the blocked (online-softmax) branch, within one key
chunk and across a chunk boundary, and the full-S masked softmax, for a bf16
cache (the one q40 weights run with) and an f32 cache.

Tolerance: the written cache is bit-identical (the same round-to-nearest
cast in both). The attention output agrees to ATT_TOL of its largest
magnitude. bf16 and f32 products are exact in f32 in both packages, so with
an f32 cache only the order of f32 sums and an ulp of exp differ (observed
<= 9.4e-7 over these cases; tolerance 2e-6). A bf16 cache also rounds the
softmax weights to bf16 before the value mix, and an ulp of exp difference
can flip one such rounding (observed 1.5e-4 on the chunk-crossing case,
<= 6.7e-7 on the others; tolerance 4e-4). Slips of the bf16 numerics show
far above that: scores rounded to bf16 give 4.3e-3 to 7.5e-3, the value mix
rounded to bf16 2.3e-3 to 2.9e-3, the exp-sum rounded to bf16 2.5e-3 on the
blocked cases, and weights left unrounded 1.3e-3 to 2.3e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.formats import synthetic as jsyn
from distributed_llama_tpu.models import config as jconfig
from distributed_llama_tpu.models import llama as jllama

from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import config as tconfig
from distributed_llama_tpu_torch.models import llama as tllama

SPEC = dict(dim=1024, hidden_dim=2048, n_layers=1, n_heads=8, n_kv_heads=4, vocab_size=512)
ATT_TOL = {"bf16": 4e-4, "f32": 2e-6}  # of max |att|, by cache dtype

# (cache seq_len, T, pos): the branch each takes under the shared rule
CASES = {
    "blocked_decode": (1024, 1, 700),
    "blocked_first_token": (1024, 1, 0),
    "blocked_across_chunk": (1024, 8, 509),
    "full_s_prefill": (1024, 12, 300),
    "full_s_small_cache": (256, 4, 100),
}


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 represents exactly (what a bf16 cache holds)."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("cache_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_teacher_forced_matches_jax(monkeypatch, case, cache_dtype):
    S, T, pos = CASES[case]
    jcfg = jconfig.config_from_spec(jsyn.tiny_spec(**SPEC, seq_len=S))
    tcfg = tconfig.config_from_spec(tsyn.tiny_spec(**SPEC, seq_len=S))
    H, K, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_size
    rng = np.random.RandomState(S + T + pos)
    q = rng.randn(T, H, hd).astype(np.float32)
    k = rng.randn(T, K, hd).astype(np.float32)
    v = rng.randn(T, K, hd).astype(np.float32)
    cache = rng.randn(2, S, K, hd).astype(np.float32)
    if cache_dtype == "bf16":
        cache = _bf16_exact(cache)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if cache_dtype == "bf16" else (jnp.float32, torch.float32)

    monkeypatch.setattr(jllama, "project_qkv", lambda *a, **kw: tuple(map(jnp.asarray, (q, k, v))))
    monkeypatch.setattr(tllama, "project_qkv", lambda *a, **kw: tuple(map(torch.from_numpy, (q, k, v))))
    want, jcache = jllama.attention(
        jcfg, jnp.zeros((T, SPEC["dim"]), jnp.float32), {}, jnp.asarray(cache).astype(jdt),
        jnp.int32(pos), None, None,
    )
    got, tcache = tllama.attention(
        tcfg, torch.zeros(T, SPEC["dim"]), {}, torch.from_numpy(cache).to(tdt), pos, None,
    )
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (T, H * hd)
    np.testing.assert_array_equal(tcache.to(torch.float32).numpy(), np.asarray(jcache.astype(jnp.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATT_TOL[cache_dtype] * np.abs(want).max())
