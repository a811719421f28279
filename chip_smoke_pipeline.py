"""`chip_smoke.py`'s pipeline- and expert-parallel phase
(`phase_pipeline_expert`), the port's `parallel/pipeline_parallel.py` and
`parallel/expert_parallel.py` on the card, with the kernel forms they run:

* its legs in `phase_parallel`'s gloo world of two processes on the card
  (`chip_smoke.py` adds the DiT's and DiM's PP 2 legs, `parallel_legs`
  the MoE's; that phase holds each rank's loss and gathered gradients
  against the one-process step on the same global batch of 32, 1e-5 and
  1e-4, and checks a rank's launches): the full-width CIFAR-10 DiT and
  DiM at pipeline parallel 2 (GPipe, two microbatches of 16 rows, dropout
  0.1: a DiT stage rank's 6 blocks launch 12 K2 and 12 K3 in the dropout
  form, a DiM stage rank's 12 K6 and 12 K8), and the MoE DiT
  (`configs/cifar10_dit_moe.py`, `moe_aux_weight` 0.01, dropout 0.1) at
  expert parallel 2 (4 of 8 experts a rank, the tokens through two
  all-to-alls a block) and at data parallel 2, where the load-balance loss
  is the global batch's (each rank's f and P averaged over 'data'); the
  MoE legs replay the one-process step's routing in their checked step
  (`replay_routing`), a router's discrete choice differing by float
  rounding otherwise;
* K2's dropout mask at a microbatch's first global row (`batch0` 16 of 32,
  v = I) read back against its rows of the one-device mask;
* the legs' first and steady (step 2) step seconds and peak memory
  a rank beside data parallel 2's, and the draw replay's cost: its seconds
  inside each of a stage rank's steps, and the PP step at dropout 0.1
  against one more at 0 (`time_replay`).

gloo's `send` aborts a rank given a CUDA tensor on the H100 machine, and
its `all_to_all_single` carries them: the pipeline stages its hand-offs
through the host under gloo, and the expert exchange does not.

Pipeline x tensor parallelism needs four ranks: the CPU tests and
`tools/dryrun_multichip.py` hold it. Every failure raises. Alone, after
`phase_build`:

    python3 -c "import torch, chip_smoke as c, chip_smoke_pipeline as p;
        smi = c.device_line(); c.phase_build();
        g = torch.Generator('cuda').manual_seed(0);
        p.phase_pipeline_expert(g, smi, c.phase_parallel(g, smi, p.parallel_legs))"
"""

from __future__ import annotations

from pathlib import Path

import torch

import chip_smoke as c
from diffusion_models_collection_tpu_torch.ops import flash_attention as fa

PP = 2  # stages
EP = 2  # expert ranks
MICROBATCH = c.PARALLEL_BATCH // PP  # rows a microbatch at data parallel 1
MOE_STEP = c.DIT_STEP  # every rank runs all 12 blocks on its rows
MASK_LENGTH = 64  # v = I: head_dim = L


# ------------------------------------------------------------------ legs
def moe_reference(config, state, batch):
    """The one-process MoE step of the legs (`chip_smoke.parallel_reference`
    with the routing recorded): loss, full gradients, the experts chosen."""
    trainer = c.parallel_trainer(config, state)
    grads = c.record_full_grads(trainer)
    torch.manual_seed(c.TRAIN_SEED)
    c.reset_launches()
    with c.recorded_choices(trainer.model) as choices:
        loss = trainer.train_step(*(batch[k].to("cuda") for k in (
            "x0", "labels", "t", "noise", "drop")))
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grads": grads[0],
           "launches": c.read_launches(),
           "experts": [e.cpu() for e in choices["experts"]]}
    del trainer
    torch.cuda.empty_cache()
    print(f"parallel MoE one-process reference: loss {out['loss']:.6f}, "
          f"launches {out['launches']}")
    return out


def _batch(config, gen):
    shape = (c.PARALLEL_BATCH, *c.image_shape(config))
    n = c.PARALLEL_BATCH
    return {"x0": torch.rand(*shape, generator=gen, device="cuda") * 2 - 1,
            "labels": torch.randint(0, 10, (n,), generator=gen,
                                    device="cuda"),
            "t": torch.randint(0, config["num_timesteps"], (n,),
                               generator=gen, device="cuda"),
            "noise": torch.randn(*shape, generator=gen, device="cuda"),
            "drop": torch.rand(n, generator=gen, device="cuda") < 0.2}


def _save(obj, path) -> str:
    torch.save(obj, path)
    return str(path)


def parallel_legs(gen, tmp):
    """(legs, references) that `phase_parallel` adds to its world: the
    MoE DiT at EP 2 and DP 2, from its random weights, batch and
    one-process reference (routing recorded) written under `tmp`. Each leg
    names its config, weights, batch and reference files, its launches a
    step."""
    config = c.load_config(c.MOE_CONFIG)
    state = c.random_model(config, gen).cpu().state_dict()
    batch = _batch(config, gen)
    base = dict(config, save_dir=str(Path(tmp) / "MoE_ckpt"),
                sample_dir=str(Path(tmp) / "MoE_samples"),
                batch_size=c.PARALLEL_BATCH)
    files = {"state": _save(state, Path(tmp) / "MoE_state.pt"),
             "batch": _save({k: v.cpu() for k, v in batch.items()},
                            Path(tmp) / "MoE_batch.pt")}
    refs = {"MoE": moe_reference(base, state, batch)}
    files["ref"] = _save(refs["MoE"], Path(tmp) / "MoE_ref.pt")
    legs = []
    for layout, changes in (("EP 2", {"expert_parallel": EP}),
                            ("DP 2", {})):
        cfg_path = Path(tmp) / f"MoE_{layout.replace(' ', '')}.py"
        cfg_path.write_text(f"config = {dict(base, **changes)!r}\n")
        legs.append(dict(name="MoE", layout=layout, step=MOE_STEP,
                         config=str(cfg_path), replay_routing=True, **files))
    return legs, refs


def check_microbatch_mask():
    """K2's dropout mask of a pipeline microbatch (rows 16 .. 31 of 32,
    `batch0` 16, the DiT's 6 heads, v = I) read back in float32 and bf16
    against its rows of the one-device mask."""
    heads, rows = c.DIT_HEADS, MICROBATCH
    full = fa.philox_keep_mask(c.ATTN_DROPOUT_SEED, 2 * rows * heads,
                               MASK_LENGTH, MASK_LENGTH, c.ATTN_DROPOUT,
                               device="cuda")[rows * heads:]
    grid = (heads, heads, rows, 0)
    gen = torch.Generator("cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k = (torch.randn(rows * heads, MASK_LENGTH, MASK_LENGTH,
                            generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        eye = torch.eye(MASK_LENGTH, device="cuda", dtype=dtype).expand(
            rows * heads, -1, -1).contiguous()
        o, _ = fa.flash_attention_fwd(q, k, eye, c.ATTN_DROPOUT,
                                      c.ATTN_DROPOUT_SEED, head_grid=grid)
        if not torch.equal(o != 0, full):
            raise AssertionError(f"microbatch mask {dtype}: not the "
                                 "one-device mask's rows")
    print(f"pipeline: K2's dropout mask of microbatch 1 (batch0 {rows} of "
          f"{2 * rows} rows, BH {rows * heads}, L {MASK_LENGTH}) read back "
          "in float32 and bf16 equals its rows of the one-device mask")


def report_legs(legs, smi):
    """Each new leg beside its data-parallel twin: the first step's and the
    steady step's seconds (the mean of the steady steps), peak memory a rank,
    and for the pipeline the replay's seconds in each step and the steady
    step at dropout 0.1 against one at 0."""
    mib = 2 ** 20
    for name, layout, twin in (("DiT", "PP 2", ("DiT", "DP 2")),
                               ("DiM", "PP 2", ("DiM", "DP 2")),
                               ("MoE", "EP 2", ("MoE", "DP 2"))):
        leg, ref = legs[(name, layout)], legs[twin]
        replay = ""
        if leg.get("replay_seconds") is not None:
            *steps, at0 = leg["replay_seconds"]
            replay = (f"; draw replay a step (steps 1 to 3, then at dropout "
                      f"0) {[round(t * 1e3, 3) for t in steps]} ms, "
                      f"{at0 * 1e3:.3f} ms; step at dropout 0 "
                      f"{leg['step_p0']:.4f} s (steady step "
                      f"{leg['steady'] / leg['step_p0']:.3f}x it)")
        print(f"{name} {layout} at global batch {c.PARALLEL_BATCH} (gloo, 2 "
              f"ranks on one card): first step {leg['seconds']:.4f} s, "
              f"steady {leg['steady']:.4f} s, peak a rank "
              f"{leg['peak'] / mib:.1f} MiB ({leg['base'] / mib:.1f} at the "
              f"step's start), error {leg['err']:.3e}{replay}; "
              f"{' '.join(twin)} first step {ref['seconds']:.4f} s, steady "
              f"{ref['steady']:.4f} s, peak {ref['peak'] / mib:.1f} MiB "
              f"({ref['base'] / mib:.1f}); first step "
              f"{leg['seconds'] / ref['seconds']:.3f}x, steady "
              f"{leg['steady'] / ref['steady']:.3f}x, peak "
              f"{leg['peak'] / ref['peak']:.3f}x; launches a rank "
              f"{ {k: v for k, v in leg['launches'].items() if v} } on {smi}")


def phase_pipeline_expert(gen, smi, parallel):
    """The microbatch mask read-back and the report of `phase_parallel`'s
    pipeline and expert legs (`parallel`: its figures)."""
    check_microbatch_mask()
    report_legs(parallel["legs"], smi)
