"""Reading of the q40 logit gaps behind the tolerance of the port's q40
engine tests (``_Q40_LOGIT_TOL`` in ``test_torch_model.py``).

    JAX_PLATFORMS=cpu python tests/torch_q40_logit_gaps.py

On the synthetic Q40 model of ``test_torch_model.py`` it prints, for each
test prompt, max |port - JAX| / max |JAX| of the logits at prefill and at
each of 12 teacher-forced greedy decode steps, and the same gap between the
JAX package's jitted prefill and its eager (``jax.disable_jit``) prefill on
the same model. Not collected by pytest: the eager forward takes tens of
seconds on a CPU.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine  # noqa: E402
from distributed_llama_tpu_torch.formats import synthetic as tsyn  # noqa: E402
from distributed_llama_tpu_torch.quants import FloatType  # noqa: E402
from test_torch_model import PROMPT_LONG, PROMPT_SHORT, SPEC  # noqa: E402

STEPS = 12


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "model.m")
        tsyn.write_synthetic_model(path, tsyn.tiny_spec(**SPEC, weights_float_type=FloatType.Q40), seed=0)
        je, te = JaxEngine(path, dtype="q40"), TorchEngine(path, dtype="q40", device="cpu")
        for name, prompt in (("blocked", PROMPT_SHORT), ("full_s", PROMPT_LONG)):
            je.reset(), te.reset()
            want, got = je.prefill(prompt), te.prefill(prompt)
            gaps = []
            for step in range(STEPS + 1):
                gaps.append(rel_gap(got, want))
                if step < STEPS:
                    tok = int(np.argmax(want))
                    want, got = je.decode_step(tok), te.decode_step(tok)
            print(f"{name}: port vs JAX, prefill then {STEPS} decode steps: "
                  + " ".join(f"{g:.2e}" for g in gaps) + f"; max {max(gaps):.2e}")
            je.reset()
            jitted = je.prefill(prompt)
            eager_engine = JaxEngine(path, dtype="q40")
            with jax.disable_jit():
                eager = eager_engine.prefill(prompt)
            print(f"{name}: JAX jitted vs eager prefill: {rel_gap(eager, jitted):.2e}")


if __name__ == "__main__":
    main()
