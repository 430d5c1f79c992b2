#!/usr/bin/env python3
"""The model-parallel GPT across four cards, held against the same model
on one card.

Run from the root of the repository on a machine with four CUDA cards::

    torchrun --nproc-per-node 4 scripts/torch_model_parallel_cards.py [--out FILE]

(``--device cpu --preset small`` runs the same checks on four Gloo ranks
at toy widths.) The weights are drawn once with numpy in the JAX
package's layout (a flax tree of ``(in, out)`` kernels) and carried to
every layout by ``models/import_weights.py``: the plain model
(``gpt_state_dict_from_flax``), a TP shard (``gpt_tp_shard_from_jax``), a
pipeline stage (``gpt_pipeline_params_from_jax``) and one rank's experts
(``moe_params_from_jax``). Rank 0 runs the plain model at world 1 on its
own card (``GPTLM``, flash attention) and
broadcasts its loss and gradients; every rank holds its part to them:

- TP at 4 model shards (``tp_gpt_forward``);
- sequence parallelism at 4 shards, ring and Ulysses;
- 1F1B at 4 stages, and at 2 data x 2 pipe (gradients meaned over data);
- MoE at 4 ranks x 2 experts against 1 rank x 8 experts (capacity = the
  tokens, no drop; ``tests/test_moe.py:65``): the logits, the
  cross-entropy and its gradients (the load-balance loss is each rank's
  own, over its tokens, so it is left out).

Each check prints one JSON line on rank 0: the largest gradient difference
(relative to ``max(1, max|plain|)`` of its leaf) and its leaf, the loss
difference, the bytes each kind of collective moved (recorded on rank 0),
and the NCCL kernels' device time in one profiled step
(``torch.profiler``). The key projections' biases, whose gradient is 0 in
exact arithmetic, are held to ``KEY_BIAS_TOL`` of their query biases'
(the largest ratio to that bound is printed). The card's name and
power limit come from ``nvidia-smi``.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-5
# a key projection's bias has a gradient of 0 in exact arithmetic (a
# softmax ignores a shift of a row's scores): both sides hold the rounding
# of a sum over every token, held to KEY_BIAS_TOL of max(1, max|plain|) of
# the same layer's query bias, a sum of the same kind that does not cancel
KEY_BIAS_TOL = 1e-7
# (dim, layers, heads, FFN, vocabulary, T, batch) of the dense checks and
# (T, batch, experts) of the MoE one
PRESETS = {
    "full": {"gpt": (768, 12, 12, 3072, 1024, 1024, 8), "moe": (256, 16, 8)},
    "small": {"gpt": (32, 4, 4, 64, 64, 32, 8), "moe": (32, 8, 8)},
}


def key_bias_bound(ref, name):
    """The bound of the key bias ``name``'s gradient: KEY_BIAS_TOL of its
    query bias's in ``ref``."""
    return KEY_BIAS_TOL * max(1.0, ref[name.replace("k_proj", "q_proj")].abs().max().item())


def flax_gpt_tree(dim, layers, heads, ffn, vocab, positions, seed, mlp=True):
    """A GPT's parameters as the JAX package's ``GPTLM`` holds them, drawn
    with numpy: kernels ``(in, out)`` of std 0.02, small biases, LayerNorm
    scales near 1, tables of std 0.02."""
    rng = np.random.RandomState(seed)
    f32 = np.float32

    def dense(i, o):
        return {"kernel": (rng.randn(i, o) * 0.02).astype(f32), "bias": (rng.randn(o) * 0.01).astype(f32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.randn(dim)).astype(f32), "bias": (0.1 * rng.randn(dim)).astype(f32)}

    tree = {
        "wte": {"embedding": (rng.randn(vocab, dim) * 0.02).astype(f32)},
        "wpe": {"embedding": (rng.randn(positions, dim) * 0.02).astype(f32)},
        "ln_f": ln(),
    }
    for i in range(layers):
        block = {"ln_1": ln(), "ln_2": ln(), "attn": {n: dense(dim, dim) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}}
        if mlp:
            block.update(mlp_fc=dense(dim, ffn), mlp_proj=dense(ffn, dim))
        tree[f"h_{i}"] = block
    return tree


def pipeline_pieces(tree, n_stages):
    """The JAX ``split_gpt_params`` + ``stacked_stage_params`` of ``tree``,
    in numpy: ``(embed, {"layers": leaves (S, L, ...)}, final)``."""
    layers = sorted((k for k in tree if k.startswith("h_")), key=lambda k: int(k[2:]))
    per = len(layers) // n_stages

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    stages = [stack([tree[layers[s * per + j]] for j in range(per)]) for s in range(n_stages)]
    return {k: tree[k] for k in ("wte", "wpe")}, {"layers": stack(stages)}, {"ln_f": tree["ln_f"]}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=list(PRESETS), default="full")
    p.add_argument("--seed", type=int, default=714)
    p.add_argument("--out", default=None, help="also write the records here, one JSON line each")
    args = p.parse_args()

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.experiments import gpt_moe
    from network_distributed_pytorch_tpu_torch.models import gpt as G
    from network_distributed_pytorch_tpu_torch.models.import_weights import (
        gpt_pipeline_params_from_jax,
        gpt_state_dict_from_flax,
        gpt_tp_shard_from_jax,
        moe_params_from_jax,
    )
    from network_distributed_pytorch_tpu_torch.ops import _build
    from network_distributed_pytorch_tpu_torch.parallel.comm import all_reduce_mean, record_collectives
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if world != 4:
        sys.exit(f"run under torchrun --nproc-per-node 4 (world {world})")
    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(
        DistributedConfig(process_id=rank, num_processes=world, coordinator_address="env://"), dev
    )
    records = []

    def emit(record):
        if rank == 0:
            records.append(record)
            sys.stdout.write(json.dumps(record) + "\n")
            sys.stdout.flush()

    try:
        if on_cuda:  # rank 0 builds the kernels; the others load them
            if rank == 0:
                _build.build_all()
            dist.barrier()
        dim, layers, heads, ffn, vocab, t, b = PRESETS[args.preset]["gpt"]
        cfg = G.GPTConfig(vocab_size=vocab, max_position_embeddings=t, dim=dim, n_layers=layers, n_heads=heads,
                          hidden_dim=ffn, dropout=0.0)
        tree = flax_gpt_tree(dim, layers, heads, ffn, vocab, t, args.seed)
        sd = gpt_state_dict_from_flax({"params": tree})
        rng = np.random.RandomState(args.seed + 1)
        ids = torch.from_numpy(rng.randint(0, vocab, (b, t + 1))).to(dev)
        x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()

        def loss_and_grads(loss, leaves):
            return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        # the plain model at world 1 on rank 0, broadcast to every rank
        ref_loss = torch.zeros((), device=dev)
        ref = {k: torch.empty_like(v, device=dev) for k, v in sd.items()}
        if rank == 0:
            model = G.GPTLM(cfg, device=dev)
            model.load_state_dict(sd)
            loss, grads = loss_and_grads(G.next_token_loss(model(x), y), dict(model.named_parameters()))
            ref_loss.copy_(loss)
            for k in ref:
                ref[k].copy_(grads[k])
            del model
        dist.broadcast(ref_loss, 0)
        for k in ref:
            dist.broadcast(ref[k], 0)

        def compare(name, loss, got, tokens, extra):
            """``got``: full names -> this rank's tensors (a slice of the
            plain gradient where ``extra["slices"]`` says so)."""
            worst, leaf, noise = 0.0, None, 0.0
            for k, g in got.items():
                want = ref[k]
                for dim_, idx, n in extra.get("slices", {}).get(k, ()):
                    want = want.chunk(n, dim=dim_)[idx]
                d = (g.float() - want.float()).abs().max().item()
                if k.endswith("attn.k_proj.bias"):
                    noise = max(noise, d / key_bias_bound(ref, k))
                else:
                    d /= max(1.0, want.abs().max().item())
                    if d > worst:
                        worst, leaf = d, k
            loss_diff = abs(loss.item() - ref_loss.item()) / max(1.0, abs(ref_loss.item()))
            summary = torch.tensor([worst, noise, loss_diff], device=dev)
            dist.all_reduce(summary, op=dist.ReduceOp.MAX)
            worst, noise, loss_diff = summary.tolist()
            ok = worst <= TOL and loss_diff <= TOL and noise <= 1.0
            emit({"check": name, "ok": ok, "max_grad_diff": worst, "max_grad_diff_leaf_rank0": leaf,
                  "loss_diff": loss_diff, "max_key_bias_grad_diff_over_bound": noise,
                  "tolerance": TOL, **{k: v for k, v in extra.items() if k != "slices"}})
            return ok

        def nccl_ms(fn):
            """Device time of the NCCL kernels of one ``fn()`` (after a warm-up)."""
            if not on_cuda:
                return None
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            return sum(e.self_device_time_total for e in prof.key_averages() if "nccl" in e.key.lower()) / 1e3

        def recorded(fn):
            with record_collectives() as recs:
                out = fn()
            by_kind = {}
            for r in recs:
                by_kind[r.kind] = by_kind.get(r.kind, 0) + r.payload_bytes
            return out, by_kind

        ok = True
        # ---- TP at 4 model shards
        mesh = make_mesh((1, 4), ("data", "model"))
        mg, mi = mesh.group("model"), mesh.axis_index("model")
        specs = G.gpt_tp_param_specs(cfg)
        shard = {k: v.to(dev) for k, v in gpt_tp_shard_from_jax(tree, specs, (mi, 4)).items()}

        def tp_step():
            leaves = {k: v.clone().requires_grad_(True) for k, v in shard.items()}
            return loss_and_grads(G.next_token_loss(G.tp_gpt_forward(cfg, leaves, x, mg), y), leaves)

        (loss, grads), kinds = recorded(tp_step)
        slices = {k: ((d, mi, 4),) for k, d in specs.items() if d is not None}
        ok &= compare("tp_4_shards", loss, grads, b * t,
                      {"collective_bytes": kinds, "nccl_ms": nccl_ms(tp_step), "slices": slices})

        # ---- sequence parallelism at 4 shards
        sg = make_mesh((4,), ("seq",)).group("seq")
        t_loc = t // 4
        xs, ys = x[:, rank * t_loc : (rank + 1) * t_loc], y[:, rank * t_loc : (rank + 1) * t_loc]
        for impl in G.SEQ_IMPLS:
            model = G.GPTLM(G.GPTConfig(**{**cfg.__dict__, "seq_axis": sg, "seq_impl": impl}), device=dev)
            model.load_state_dict(sd)

            def sp_step(model=model):
                leaves = dict(model.named_parameters())
                local = G.next_token_loss(model(xs), ys)
                _, grads = loss_and_grads(local / 4, leaves)
                grads = {k: all_reduce_mean(g.contiguous(), sg) * 4 for k, g in grads.items()}
                return all_reduce_mean(local.detach().reshape(1), sg)[0], grads

            (loss, grads), kinds = recorded(sp_step)
            ok &= compare(f"sequence_{impl}_4_shards", loss, grads, b * t,
                          {"collective_bytes": kinds, "nccl_ms": nccl_ms(sp_step)})
            del model

        # ---- 1F1B at 4 stages, and 2 data x 2 pipe
        for n_data, n_stages in ((1, 4), (2, 2)):
            mesh = make_mesh((n_data, n_stages), ("data", "pipe"))
            pg, s, d = mesh.group("pipe"), mesh.axis_index("pipe"), mesh.axis_index("data")
            dg = mesh.group("data")
            per = layers // n_stages
            embed, stage, final = (
                {k: v.to(dev) for k, v in part.items()}
                for part in gpt_pipeline_params_from_jax(*pipeline_pieces(tree, n_stages), s)
            )
            train = G.make_gpt_pipeline_train_fn(cfg, per, 4, pg)
            rows = b // n_data
            xd, yd = x[d * rows : (d + 1) * rows], y[d * rows : (d + 1) * rows]

            def pp_step(train=train, embed=embed, stage=stage, final=final, xd=xd, yd=yd, dg=dg):
                loss, (ge, gs, gf) = train(embed, stage, final, xd, yd)
                mean = lambda v: all_reduce_mean(v.contiguous(), dg)  # noqa: E731
                grads = {**{k: mean(v) for k, v in ge.items()}, **{k: mean(v) for k, v in gf.items()}}
                for k, v in gs.items():
                    for j in range(per):
                        grads[f"h.{s * per + j}.{k}"] = mean(v[j])
                return all_reduce_mean(loss.reshape(1), dg)[0], grads

            (loss, grads), kinds = recorded(pp_step)
            ok &= compare(f"1f1b_{n_data}data_{n_stages}pipe", loss, grads, b * t,
                          {"microbatches": 4, "collective_bytes": kinds, "nccl_ms": nccl_ms(pp_step)})

        # ---- MoE: 4 ranks x 2 experts against 1 rank x 8 experts
        mt, mb, n_experts = PRESETS[args.preset]["moe"]
        mcfg = G.GPTConfig(vocab_size=vocab, max_position_embeddings=mt, dim=dim, n_layers=layers, n_heads=heads,
                           hidden_dim=2 * dim, dropout=0.0)
        base_tree = flax_gpt_tree(dim, layers, heads, ffn, vocab, mt, args.seed + 2, mlp=False)
        mrng = np.random.RandomState(args.seed + 3)
        routers = {f"h_{i}": (mrng.randn(dim, n_experts) / math.sqrt(dim)).astype(np.float32) for i in range(layers)}
        experts = {
            f"h_{i}": {
                "w_up": (mrng.randn(n_experts, dim, 2 * dim) / math.sqrt(dim)).astype(np.float32),
                "b_up": (0.01 * mrng.randn(n_experts, 2 * dim)).astype(np.float32),
                "w_down": (mrng.randn(n_experts, 2 * dim, dim) / math.sqrt(2 * dim)).astype(np.float32),
                "b_down": (0.01 * mrng.randn(n_experts, dim)).astype(np.float32),
            }
            for i in range(layers)
        }
        mids = torch.from_numpy(mrng.randint(0, vocab, (mb, mt + 1))).to(dev)
        mx, my = mids[:, :-1].contiguous(), mids[:, 1:].contiguous()
        eg = make_mesh((4,), ("expert",)).group("expert")

        def moe_grads(coord, group, xx, yy, capacity):
            base, rts, exps = (
                {k: v.to(dev).requires_grad_(True) for k, v in part.items()}
                for part in moe_params_from_jax(base_tree, routers, experts, coord)
            )
            # cross-entropy only: the load-balance loss is each rank's own
            # (fractions of its tokens), not the one-rank run's
            logits, _, dropped = gpt_moe.moe_gpt_forward(mcfg, base, exps, rts, xx, capacity, group)
            loss = G.next_token_loss(logits, yy)
            leaves = {**{f"base/{k}": v for k, v in base.items()}, **{f"router/{k}": v for k, v in rts.items()},
                      **{f"expert/{k}": v for k, v in exps.items()}}
            return loss.detach(), logits.detach(), dropped.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        rows = mb // 4
        mref = {}
        if rank == 0:  # 1 rank x 8 experts over the whole batch, every token kept
            loss1, logits1, dropped1, grads1 = moe_grads((0, 1), None, mx, my, mb * mt)
            mref = {"loss": loss1, "logits": logits1, **grads1}

        def moe_step():
            return moe_grads((rank, 4), eg, mx[rank * rows : (rank + 1) * rows], my[rank * rows : (rank + 1) * rows], rows * mt)

        (loss4, logits4, dropped4, grads4), kinds = recorded(moe_step)
        names = sorted(grads4)
        # rank 0's one-rank run, broadcast: full experts, full batch
        full_shapes = {"loss": (), "logits": (mb, mt, vocab)}
        for k in names:
            s_ = tuple(grads4[k].shape)
            full_shapes[k] = (s_[0] * 4,) + s_[1:] if k.startswith("expert/") else s_
        for k in ("loss", "logits", *names):
            buf = mref[k] if rank == 0 else torch.empty(full_shapes[k], device=dev)
            dist.broadcast(buf, 0)
            mref[k] = buf
        local = {
            "logits": (logits4 - mref["logits"][rank * rows : (rank + 1) * rows]).abs().max().item()
            / max(1.0, mref["logits"].abs().max().item()),
        }
        worst, leaf, noise = local["logits"], "logits", 0.0
        for k in names:
            g = grads4[k]
            if k.startswith("expert/"):
                want = mref[k].chunk(4, dim=0)[rank]
                g = g / 4  # the all-to-all's backward summed the 4 ranks' local-mean gradients
            else:
                want = mref[k]
                g = all_reduce_mean(g.contiguous(), eg)
            dd = (g - want).abs().max().item()
            if k.endswith("attn.k_proj.bias"):
                noise = max(noise, dd / key_bias_bound(mref, k))
                continue
            dd /= max(1.0, want.abs().max().item())
            if dd > worst:
                worst, leaf = dd, k
        mean_loss = all_reduce_mean(loss4.reshape(1).clone(), eg)[0]
        loss_diff = abs(mean_loss.item() - mref["loss"].item()) / max(1.0, abs(mref["loss"].item()))
        summary = torch.tensor([worst, noise, loss_diff, dropped4.item()], device=dev)
        dist.all_reduce(summary, op=dist.ReduceOp.MAX)
        worst, noise, loss_diff, dropped = summary.tolist()
        moe_ok = worst <= TOL and loss_diff <= TOL and noise <= 1.0 and dropped == 0.0
        ok &= moe_ok
        emit({"check": "moe_4x2_vs_1x8", "ok": moe_ok, "max_diff": worst, "max_diff_leaf_rank0": leaf,
              "loss_diff": loss_diff, "max_key_bias_grad_diff_over_bound": noise,
              "dropped_fraction": dropped, "tolerance": TOL, "collective_bytes": kinds, "nccl_ms": nccl_ms(moe_step)})

        smi = None
        if on_cuda and rank == 0:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip().splitlines()
        emit({"all_ok": bool(ok), "world": world, "device": args.device, "preset": args.preset, "nvidia_smi": smi})
        if rank == 0 and args.out:
            with open(args.out, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    finally:
        shutdown_distributed()
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
