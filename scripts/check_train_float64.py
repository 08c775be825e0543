"""The fine training step's GNN, apart, in f32 and float64, in both packages.

On the fine fixture batch (``text2pos_torch/fixtures/bench_train_step.npz``:
16 poses of the recipe's training scene, JAX's draws) the port encodes the
objects and hints in train mode, in f32 and in float64
(``text2pos_torch/utils/float64.py``). On those encodings the matcher (GNN,
Sinkhorn, matching loss) of the committed ``bench_fine`` checkpoint is
differentiated four ways: the port and JAX (``jax_enable_x64`` with its
float32 pins widened), each in f32 and float64. Printed, per pair, the loss's
relative difference and the worst gradient leaves (relative L2): how far each
package's f32 GNN is from float64, whether the two float64 GNNs agree, and how
far the float64 gradient moves when its input encodings move by f32's
rounding (the f32 encodings; random noise of 6e-8 and 1e-6 relative).

Imports JAX and the JAX package; not part of the port. CPU only, a few GB of
memory, about two minutes:

    JAX_PLATFORMS=cpu python scripts/check_train_float64.py
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def jax_float64():
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = f32


def main():
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as smoke
    from text2pos_torch.models.blocks import train_mode
    from text2pos_torch.train.losses import matching_loss
    from text2pos_torch.utils.convert_jax import params_to_jax
    from text2pos_torch.utils.float64 import float64_pins
    from text2pos_tpu.config import TrainConfig as JConfig
    from text2pos_tpu.data.hints import Vocabulary as JVocab
    from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
    from text2pos_tpu.train.losses import matching_loss as jmatching_loss
    from text2pos_tpu.train.state import restore_variables

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    tx = dict(np.load(smoke.TRAIN_FIXTURE))
    train, _, vocab = smoke.train_data()
    batch = next(smoke.stage_loader("fine", train, vocab, 16).epoch(seed=1))
    draws = {"idx": tx["fine_idx"].astype(np.int64),
             "angles": tx["fine_angles"]}
    am = torch.from_numpy(batch["all_matches"])
    cnt = torch.from_numpy(batch["all_matches_count"])

    def port_model(f64):
        trainer = smoke.make_trainer("fine", vocab, device="cpu")
        model = trainer.init_state(1).model
        if f64:
            model.double()
        return trainer, model

    def encodings(f64):
        pins = float64_pins() if f64 else contextlib.nullcontext()
        with pins, torch.no_grad():
            trainer, model = port_model(f64)
            tb = trainer.tensors(batch)
            with train_mode(model, True):
                pts, cols = trainer.points(tb, True, draws=draws)
                hint = model.encode_hints(tb["hint_tokens"],
                                          tb["hint_lengths"])
                obj = model.encode_cell_objects(pts, cols, tb["centers"],
                                                tb["colors"])
        return obj.double(), hint.double()

    def port_grads(obj, hint, f64):
        pins = float64_pins() if f64 else contextlib.nullcontext()
        with pins:
            _, model = port_model(f64)
            dt = torch.float64 if f64 else torch.float32
            with train_mode(model, True):
                out = model.match_encoded(obj.to(dt), hint.to(dt))
            loss = matching_loss(out["log_P"], am, cnt)
            loss.backward()
            grads = params_to_jax(model, {
                n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in model.named_parameters()})
        return float(loss), dict(smoke.flat_tree(grads["superglue"]))

    jtrainer = JFineTrainer(JConfig(**smoke.TRAIN_RECIPE["fine"]),
                            JVocab(vocab.known_words))
    variables = restore_variables(smoke.CKPT_FINE)

    def jax_grads(obj, hint, f64):
        pins = jax_float64() if f64 else contextlib.nullcontext()
        dt = np.float64 if f64 else np.float32
        with pins:
            cast = lambda t: jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a, dt)), t)
            stats = cast(variables["batch_stats"])
            o, h = jnp.asarray(obj.numpy(), dt), jnp.asarray(hint.numpy(), dt)

            def loss_fn(params):
                out, _ = jtrainer.model.apply(
                    {"params": params, "batch_stats": stats}, o, h,
                    train=True, mutable=["batch_stats"],
                    method=type(jtrainer.model).match_encoded)
                return jmatching_loss(out["log_P"], jnp.asarray(am.numpy()),
                                      jnp.asarray(cnt.numpy()))
            loss, grads = jax.value_and_grad(loss_fn)(
                cast(variables["params"]))
            grads = jax.tree.map(np.asarray, grads)
        return float(loss), dict(smoke.flat_tree(grads["superglue"]))

    def compare(label, got, ref):
        total = np.sqrt(sum(np.linalg.norm(v) ** 2 for v in ref[1].values()))
        errs = sorted(((float(np.linalg.norm(
            np.asarray(got[1][k], np.float64) - v) / np.linalg.norm(v)), k)
            for k, v in ref[1].items()
            if np.linalg.norm(v) > smoke.ZERO_GRAD_FRACTION * total),
            reverse=True)
        print(f"{label}: loss rel {abs(got[0] - ref[0]) / abs(ref[0]):.2e}; "
              "worst leaves " + ", ".join(f"{k} {e:.2e}"
                                          for e, k in errs[:3]), flush=True)

    obj32, hint32 = encodings(False)
    obj64, hint64 = encodings(True)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    print(f"f32 encodings against float64: objects {rel(obj32, obj64):.2e}, "
          f"hints {rel(hint32, hint64):.2e} (relative L2)", flush=True)
    exact = port_grads(obj64, hint64, True)
    compare("port float64 vs JAX float64 (float64 encodings)", exact,
            jax_grads(obj64, hint64, True))
    on32 = port_grads(obj32, hint32, True)
    compare("port f32 vs port float64 (f32 encodings)",
            port_grads(obj32, hint32, False), on32)
    compare("JAX f32 vs JAX float64 (f32 encodings)",
            jax_grads(obj32, hint32, False), jax_grads(obj32, hint32, True))
    compare("port float64: f32 encodings vs float64 encodings", on32, exact)
    gen = torch.Generator().manual_seed(0)
    for eps in (6e-8, 1e-6):
        noisy = obj64 * (1 + eps * torch.randn(obj64.shape, generator=gen,
                                               dtype=torch.float64))
        compare(f"port float64: encodings with {eps:g} relative noise vs "
                "float64 encodings", port_grads(noisy, hint64, True), exact)


if __name__ == "__main__":
    main()
