"""Second witness for the port's evidence run (btcvae_dsprites), on the
CPU, through the JAX package: both packages are imported, as only tests
do. Needs the full dsprites lattice cache (tools/fabricate_dsprites.py).

  python tests/evidence_witness.py score MODEL_PT --root DSPRITES_DIR
      Score a port checkpoint (model.pt) with the JAX package's Evaluator,
      corrected and reference-faithful, and print MIG, AAM and the per-
      factor terms: the port's own evaluator's numbers are held against
      JAX's on one trained model.

  python tests/evidence_witness.py trajectory N_STEPS --root DSPRITES_DIR
      Train the JAX package and the port side by side at the evidence
      settings (b64, lr 5e-4, A/B/G = 1/6.4/1, MSS at N = 737,280,
      reg_anneal 10,000, float32) for N_STEPS steps from one init (JAX's,
      seed 1234), the JAX loader's epoch-0 order and JAX's noise stream,
      and a third run, the port from its own init and noise (seed 2), for
      the spread between two seeds. Prints, every 500 steps, the mean of
      each logged term over the last 500 steps of each run, and the
      largest relative parameter difference between the two shared runs.

  python tests/evidence_witness.py init DIR
      Write the init the JAX CLI trains btcvae_dsprites from at -s 1234:
      init_specific_model("Burgess", (1, 64, 64), 10) at
      jax.random.split(jax.random.PRNGKey(1234), 3)[0], saved with the
      JAX package's save_model (model.npz, specs.json; the specs also name
      the key, the JAX version and its threefry mode). The port's
      evidence run starts from it with `--init-from DIR`; the committed
      copy is tests/data/jax_init_btcvae_dsprites_s1234/.

score and trajectory write a JSON record with --out.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

B, D, LR = 64, 10, 5e-4
LOSS_KW = dict(rec_dist="bernoulli", reg_anneal=10000, btcvae_A=1,
               btcvae_B=6.4, btcvae_G=1)
TERMS = ["loss", "recon_loss", "mi_loss", "tc_loss", "dw_kl_loss",
         "kl_loss"]
WINDOW = 500


def score(args):
    from disvae_tpu.data.datasets import DataLoader, DSprites
    from disvae_tpu.models.vae import init_specific_model
    from disvae_tpu.ops import losses as JL
    from disvae_tpu.train.evaluate import Evaluator
    from disvae_tpu.utils.torch_compat import load_torch_checkpoint
    ds = DSprites(root=args.root)
    model, _ = init_specific_model("Burgess", (1, 64, 64), D,
                                   key=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    load_torch_checkpoint(args.path))
    loss_f = JL.get_loss_f("btcvae", n_data=len(ds), **LOSS_KW)
    record = {}
    for mode, quirk in [("corrected", False), ("reference-faithful", True)]:
        evaluator = Evaluator(model, params, loss_f, save_dir=args.scratch,
                              is_progress_bar=False, scramble_quirk=quirk,
                              metrics_seed=args.seed, resident="never")
        t0 = time.perf_counter()
        metrics = evaluator.compute_metrics(
            DataLoader(ds, batch_size=1000, shuffle=False))
        helpers = evaluator.last_metrics_internals
        record[mode] = dict(metrics, seconds=time.perf_counter() - t0,
                            mig_k=np.asarray(helpers["mig_k"]).tolist(),
                            aam_k=np.asarray(helpers["aam_k"]).tolist())
        print(mode, json.dumps(record[mode]), flush=True)
    return record


def trajectory(args):
    from disvae_tpu.data.datasets import DataLoader, DSprites
    from disvae_tpu.models.vae import init_specific_model as jax_init
    from disvae_tpu.ops import losses as JL
    from disvae_tpu.train.state import create_train_state as jax_state
    from disvae_tpu.train.steps import make_optimizer as jax_optimizer
    from disvae_tpu.train.steps import make_resident_multi_train_step
    from disvae_tpu_torch.models.vae import VAE, init_specific_model
    from disvae_tpu_torch.ops import losses as PL
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import make_optimizer, make_train_step
    from disvae_tpu_torch.utils.torch_compat import from_jax_params

    ds = DSprites(root=args.root)
    n = len(ds)
    wire = np.concatenate([
        np.packbits(np.asarray(ds.imgs[i:i + 65536], np.uint8)
                    .reshape(-1, 64 * 64), axis=1)
        for i in range(0, n, 65536)])
    idx = DataLoader(ds, batch_size=B, shuffle=True, seed=1234) \
        .epoch_order()[:args.steps * B].reshape(args.steps, B)
    j_cfg = JL.get_loss_f("btcvae", n_data=n, **LOSS_KW)
    p_cfg = PL.get_loss_f("btcvae", n_data=n, **LOSS_KW)
    model, params = jax_init("Burgess", (1, 64, 64), D,
                             key=jax.random.PRNGKey(1234))
    state = jax_state(model, params, jax_optimizer(LR),
                      jax.random.PRNGKey(7), loss_cfg=j_cfg)
    multi = make_resident_multi_train_step(model, j_cfg, jax_optimizer(LR),
                                           donate=False)
    j_wire = jnp.asarray(wire)

    shared = VAE((1, 64, 64), D)
    shared.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    other = init_specific_model("Burgess", (1, 64, 64), D,
                                generator=torch.Generator().manual_seed(2))
    runs = {name: create_train_state(m, make_optimizer(m.parameters(), LR),
                                     torch.Generator().manual_seed(2),
                                     loss_cfg=p_cfg)
            for name, m in (("port", shared), ("port_seed2", other))}
    step = make_train_step(p_cfg)
    t_wire = torch.from_numpy(wire)
    log = {name: {k: [] for k in TERMS}
           for name in ("jax", "port", "port_seed2")}
    record = {"windows": [], "param_rel": []}
    rng, k = state.rng, 50
    t0 = time.perf_counter()
    for k0 in range(0, args.steps, k):
        rows = idx[k0:k0 + k]
        state, metrics = multi(state, j_wire, jnp.asarray(rows, jnp.int32))
        for key in TERMS:
            log["jax"][key].extend(np.asarray(metrics[key]).tolist())
        for row in rows:
            rng, sub = jax.random.split(rng)  # the JAX step's own draw
            eps = torch.from_numpy(np.array(jax.random.normal(sub, (B, D))))
            batch = t_wire.index_select(0, torch.from_numpy(row))
            for name, noise in (("port", {"eps": eps}),
                                ("port_seed2", None)):
                out = step(runs[name], batch, noise)
                for key in TERMS:
                    log[name][key].append(float(out[key]))
        done = k0 + len(rows)
        if done % WINDOW == 0 or done == args.steps:
            window = {name: {key: float(np.mean(v[-WINDOW:]))
                             for key, v in terms.items()}
                      for name, terms in log.items()}
            j_params = from_jax_params(
                jax.tree_util.tree_map(np.array, state.params))
            rel = max(float(np.linalg.norm(j_params[name].numpy()
                                           - p.detach().numpy())
                            / np.linalg.norm(j_params[name].numpy()))
                      for name, p in shared.state_dict().items())
            record["windows"].append(dict(step=done, **window))
            record["param_rel"].append((done, rel))
            print("step {} ({:.0f} s): {}; params max rel diff {:.3e}"
                  .format(done, time.perf_counter() - t0, "; ".join(
                      "{} loss {:.3f} tc {:.3f} dw_kl {:.3f}".format(
                          name, w["loss"], w["tc_loss"], w["dw_kl_loss"])
                      for name, w in window.items()), rel), flush=True)
    record["per_step"] = log
    return record


INIT_SEED = 1234


def init_weights(seed=INIT_SEED):
    """(model, params, metadata) of the JAX CLI's init at `-s seed` for a
    Burgess 64x64x1 latent-10 model (disvae_tpu/cli.py: the first of three
    keys split from PRNGKey(seed))."""
    from disvae_tpu.models.vae import init_specific_model
    init_key = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    model, params = init_specific_model("Burgess", (1, 64, 64), D,
                                        key=init_key)
    metadata = dict(img_size=[1, 64, 64], latent_dim=D,
                    model_type="Burgess",
                    init_key="jax.random.split(jax.random.PRNGKey({}), 3)[0]"
                    .format(seed),
                    jax_version=jax.__version__,
                    jax_threefry_partitionable=bool(
                        jax.config.jax_threefry_partitionable))
    return model, params, metadata


def init(args):
    from disvae_tpu.utils.modelIO import save_model
    model, params, metadata = init_weights()
    os.makedirs(args.path, exist_ok=True)
    save_model(model, params, args.path, metadata=metadata)
    print("wrote {} ({} parameters)".format(args.path, sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))))
    return metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=["score", "trajectory", "init"])
    parser.add_argument("path_or_steps")
    parser.add_argument("--root",
                        help="directory of the dsprites lattice cache "
                        "(score and trajectory)")
    parser.add_argument("--seed", type=int, default=1234,
                        help="the metric sample draws' seed (score)")
    parser.add_argument("--scratch", default=".",
                        help="where the evaluator writes its helpers")
    parser.add_argument("--out", help="JSON record")
    args = parser.parse_args(argv)
    if args.what == "init":
        args.path = args.path_or_steps
        init(args)
        return
    if args.root is None:
        parser.error("{} needs --root".format(args.what))
    if args.what == "score":
        args.path = args.path_or_steps
        record = score(args)
    else:
        args.steps = int(args.path_or_steps)
        torch.set_num_threads(4)
        record = trajectory(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)


if __name__ == "__main__":
    main()
