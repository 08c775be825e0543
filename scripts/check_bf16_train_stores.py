"""Where the port's bf16 training forward and JAX's compiled one part.

On the CPU, at the tiny coarse step of
``tests/test_torch_port_train_coarse.py`` (``test_bf16_step_close_to_jax``:
two synthetic scenes, batch 4, embed 32, 32 points; JAX's points handed to
the port), this script prints:

1. the values XLA stores in bf16 in the compiled train-mode forward
   (``jax.jit(...).lower(...).compile().as_text()``: every f32 → bf16
   ``convert`` of a named op) beside those of the eval-mode forward, whose
   stores the port's modules repeat (``models/blocks.py``);
2. the loss of both packages;
3. per module, the share of outputs where the two differ and the largest
   difference (JAX's captured intermediates against the port's forward
   hooks, the port's outputs rounded to bf16 where JAX's are bf16);
4. for PointNet's first set abstraction, the share of its ``bn_0``
   outputs (the valid neighbour rows) where JAX and the port differ from
   the same BN computed with float64 statistics and rounded to bf16, and
   the median distance of JAX's differing values from the bf16 rounding
   boundary.

Run from the repository root (about a minute, JAX on the CPU):

    JAX_PLATFORMS=cpu python scripts/check_bf16_train_stores.py
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12)


def bf16_stores(hlo: str) -> set:
    """Op names (after ``encode_objects/``) of the values converted from
    f32 to bf16 in a compiled program."""
    defs, out = {}, set()
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%(\S+) = (\S+) (\S+?)\((.*?)\)", line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]+)"', line)
        defs[m.group(1)] = (m.group(2), m.group(3), m.group(4),
                            op.group(1) if op else "")
        ty, opc, args, _ = defs[m.group(1)]
        src = defs.get(args.strip("%"))
        if ty.startswith("bf16") and opc == "convert" and src and src[3]:
            out.add(src[3].split("encode_objects/")[-1])
    return out


def main() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from text2pos_tpu.config import TrainConfig as JConfig
    from text2pos_tpu.data.hints import Vocabulary as JVocab
    from text2pos_tpu.data.hints import build_vocabulary, \
        create_hint_description
    from text2pos_tpu.data.loaders import CoarseLoader as JLoader
    from text2pos_tpu.data.synthetic import make_synthetic_dataset
    from text2pos_tpu.ops.transforms import prepare_object_points
    from text2pos_tpu.train import losses as jlosses
    from text2pos_tpu.train.coarse import CoarseTrainer as JTrainer
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.data.hints import Vocabulary
    from text2pos_torch.models.blocks import train_mode
    from text2pos_torch.ops.pointconv import ball_neighbors
    from text2pos_torch.ops.pooling import gather_neighbors
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.state import TrainState
    from text2pos_torch.utils.convert_jax import load_jax_params

    torch.set_num_threads(4)
    cells, poses = [], []
    for s in (0, 1):
        c, p = make_synthetic_dataset(seed=s, scene_name=f"999{s}",
                                      extent=60.0, num_mentioned=6,
                                      poses_per_cell=3)
        cells, poses = cells + c, poses + p
    vocab = JVocab(build_vocabulary([create_hint_description(p)
                                     for p in poses]))
    loader = JLoader(cells, poses, vocab, 4, 16, 32, 48, shuffle_hints=True,
                     flip_poses=True, seed=0)
    rng = jax.random.PRNGKey(0)
    state = JTrainer(JConfig(**TINY), vocab).init_state(
        next(loader.epoch(seed=0)), rng, 5)
    batch = next(loader.epoch(seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    pts, cols = jax.jit(lambda b, r: prepare_object_points(
        b["points_xyz"], b["points_rgb"], b["point_count"], 32, r,
        augment=True))(jb, jax.random.fold_in(rng, 0))
    model = JTrainer(JConfig(**TINY, dtype="bfloat16"), vocab).model

    def forward(params, train, capture=False):
        return model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jb["tokens"], jb["lengths"], pts, cols, jb["centers"],
            jb["colors"], jb["class_idx"], jb["color_idx"], jb["flat_valid"],
            jb["cell_idx"], jb["slot_idx"], 4, 16, train=train,
            mutable=["batch_stats", "intermediates"] if capture else
            (["batch_stats"] if train else False),
            capture_intermediates=capture)

    stores = {}
    for train in (True, False):
        hlo = jax.jit(lambda p: forward(p, train)).lower(
            state.params).compile().as_text()
        stores[train] = bf16_stores(hlo)
    print(f"1. bf16 stores: train {len(stores[True])}, eval "
          f"{len(stores[False])}; train only: "
          f"{sorted(stores[True] - stores[False])}; eval only: "
          f"{sorted(stores[False] - stores[True])}")

    (text, cell_enc), upd = jax.jit(lambda p: forward(p, True, True))(
        state.params)
    jloss = float(jlosses.pairwise_ranking_loss(text, cell_enc, 0.35))
    inter = upd["intermediates"]
    valid = batch["flat_valid"].astype(bool)
    trainer = CoarseTrainer(TrainConfig(**TINY, device="cpu",
                                        dtype="bfloat16"),
                            Vocabulary(vocab.known_words))
    load_jax_params(trainer.model, jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.batch_stats))
    got = {}
    for name, mod in trainer.model.named_modules():
        mod.register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, o))
    tpts = (np.asarray(pts)[valid], np.asarray(cols)[valid])
    with torch.no_grad():
        loss = float(trainer.forward_loss(TrainState(trainer.model), batch,
                                          draws={"points": tpts}))
    print(f"2. loss: port {loss:.7f}, JAX {jloss:.7f}, relative distance "
          f"{abs(loss - jloss) / abs(jloss):.3e}")

    print("3. share of outputs that differ, by module:")
    for path in ("object_encoder/pointnet/sa1", "object_encoder/pointnet/sa2",
                 "object_encoder/pointnet/sa3", "object_encoder/pointnet/ga",
                 "object_encoder/color_encoder",
                 "object_encoder/pos_encoder", "object_encoder/mlp_pointnet",
                 "object_encoder", "graph1", "lin", "language_encoder"):
        node = inter
        for k in path.split("/"):
            node = node[k]
        raw = node["__call__"][0]
        raw = raw[0] if isinstance(raw, tuple) else raw
        a = np.asarray(raw, np.float32)
        g = got[path.replace("/", ".")]
        g = (g[0] if isinstance(g, tuple) else g).detach()
        if raw.dtype == jnp.bfloat16:
            g = g.to(torch.bfloat16)
        g = g.float().numpy()
        if path.startswith("object_encoder") and a.shape[0] != g.shape[0]:
            a = a[valid]
        print(f"   {path}: {float((a != g).mean()):.4f} (max |diff| "
              f"{float(np.abs(a - g).max()):.3e})")

    sa = trainer.model.object_encoder.pointnet.sa1
    with torch.no_grad(), train_mode(sa):
        a_, pos, c_, cent = sa.pointconv_args(torch.as_tensor(tpts[1]),
                                              torch.as_tensor(tpts[0]))[:4]
        idx, vm = ball_neighbors(pos, cent, sa.radius, 32)
        d = gather_neighbors(a_, idx).float() - c_.float()[:, :, None, :]
        port = sa.conv_mlp.bn_0(d, mask=vm).to(torch.bfloat16).float()
        bn = sa.conv_mlp.bn_0
        x, m = d.double().flatten(0, -2), vm.reshape(-1, 1).double()
        mean = (x * m).sum(0) / m.sum()
        var = (((x - mean) ** 2) * m).sum(0) / m.sum()
        y = ((d.double() - mean) / torch.sqrt(var + bn.eps)
             * bn.weight.double() + bn.bias.double())
    exact = y.float().to(torch.bfloat16).float().numpy()
    jax_bn0 = np.asarray(inter["object_encoder"]["pointnet"]["sa1"][
        "conv_mlp"]["bn_0"]["__call__"][0], np.float32)[valid]
    vmask = vm.numpy()
    jflip = (jax_bn0 != exact)[vmask]
    pflip = (port.numpy() != exact)[vmask]
    yv, jv, ev = y.numpy()[vmask], jax_bn0[vmask], exact[vmask]
    margin = np.abs(yv - (jv + ev) / 2) / np.abs(yv)
    print(f"4. sa1 bn_0 ({vmask.sum()} rows x {d.shape[-1]}): differ from "
          f"the float64-statistics BN rounded to bf16: JAX {jflip.mean():.5f}"
          f", port {pflip.mean():.5f}; JAX's differing values lie a median "
          f"{np.median(margin[jflip]):.2e} (relative) from the rounding "
          f"boundary")


if __name__ == "__main__":
    main()
