"""How far a bf16 c2 request's views move with the batch it rides in, in
both packages on the CPU: the c2 preset at full width (bf16, seed-0 weights
of the port's ``Model.init_random``, handed to the JAX model through
``weights.to_flax``) run on 16 rows of a c2 batch (B = 16, T = 1, K = 8,
the port's ``SyntheticScenes``, seed 0) and on the same rows as two halves
of 8. Prints, per package and dtype, the max and mean |difference| of the
views and the shares of elements off by more than 1e-2 and 1e-1; for the
port also the first module (forward hooks, in call order) whose output
differs between the two runs, and for JAX the first flax module
(``capture_intermediates``).

    JAX_PLATFORMS=cpu python tests/_torch_batch_gap.py [--dtypes bfloat16 float32]

Not a test: one c2 forward of 16 rows in each framework takes a few GiB
and about a minute on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _stats(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return {"max": float(d.max()), "mean": float(d.mean()),
            ">1e-2": float((d > 1e-2).mean()),
            ">1e-1": float((d > 1e-1).mean())}


def _batch(seed: int = 0) -> dict:
    from dynamic_multiview_3d_torch.data import synthetic
    scenes = synthetic.SyntheticScenes(num_scenes=64, image_size=128,
                                       seq_len=1, num_targets=8, seed=seed)
    raw = scenes.batch(range(16, 32), raw=True)
    return {"image_seq": synthetic.to_model(raw["image_seq"]),
            "src_poses": raw["src_poses"], "tgt_poses": raw["tgt_poses"]}


def port_gap(cfg, batch) -> dict:
    """The port's 16 rows against 8 + 8, and the first module whose
    output differs."""
    import torch
    from dynamic_multiview_3d_torch.api import Model
    torch.manual_seed(0)
    model = Model.init_random(cfg, seed=0, device="cpu")
    module = model.module
    seen: list = []

    def hook(name):
        def fn(_, __, out):
            if isinstance(out, torch.Tensor):
                seen.append((name, out.detach().float().clone()))
        return fn
    handles = [m.register_forward_hook(hook(n))
               for n, m in module.named_modules() if n]
    args = [torch.as_tensor(batch[k]) for k in
            ("image_seq", "src_poses", "tgt_poses")]
    with torch.inference_mode():
        whole = module(*args)["view"].float().numpy()
        rec_whole = list(seen)
        seen.clear()
        halves = []
        recs = []
        for i in (0, 8):
            halves.append(module(*(a[i:i + 8] for a in args))["view"]
                          .float().numpy())
            recs.append(list(seen))
            seen.clear()
    for h in handles:
        h.remove()
    first = None
    for (name, w), (_, h0), (_, h1) in zip(rec_whole, *recs):
        h = torch.cat([h0, h1])
        if h.shape == w.shape and not torch.equal(h, w):
            d = (h - w).abs()
            first = {"module": name, "shape": list(w.shape),
                     "max": float(d.max()), "mean": float(d.mean())}
            break
    return {"views": _stats(whole, np.concatenate(halves)),
            "first_module": first}, [name for name, _ in rec_whole]


def _rows(whole: np.ndarray, h0: np.ndarray, h1: np.ndarray):
    """The two halves joined along the axis that holds the rows (a
    scanned module's outputs carry the T axis first), or None."""
    for axis in range(whole.ndim):
        if whole.shape[axis] == h0.shape[axis] + h1.shape[axis] and \
                h0.shape[:axis] + h0.shape[axis + 1:] == \
                whole.shape[:axis] + whole.shape[axis + 1:]:
            return np.concatenate([h0, h1], axis=axis)
    return None


def _dotted(path) -> str:
    """A flax intermediate's path as the port's module name:
    ``['recurrent']['encoder']['stem']['conv']['__call__'][0]`` ->
    ``recurrent.encoder.stem.conv``."""
    names = []
    for key in path:
        name = getattr(key, "key", None)
        if name == "__call__":
            break
        if isinstance(name, str):
            names.append(name)
    return ".".join(names)


def jax_gap(cfg_dict, params, batch, order) -> dict:
    """The JAX package's 16 rows against 8 + 8, and the first flax module
    whose output differs, in the port's call ``order`` of the same names
    (the model's output last)."""
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu import config as jconfig
    from dynamic_multiview_3d_tpu.models import DMV3D
    jcfg = jconfig.from_dict(cfg_dict)
    module = DMV3D(jcfg.model)
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def run(seq, src, tgt):
        out, inter = module.apply({"params": p}, seq, src, tgt,
                                  capture_intermediates=True,
                                  mutable=["intermediates"])
        return out["view"], inter["intermediates"]
    args = [jnp.asarray(batch[k]) for k in
            ("image_seq", "src_poses", "tgt_poses")]
    whole, iw = run(*args)
    parts = [run(*(a[i:i + 8] for a in args)) for i in (0, 8)]
    halves = np.concatenate([np.asarray(v, np.float32) for v, _ in parts])
    rank = {name: i for i, name in enumerate(order)}
    differ = []
    flat_w = jax.tree_util.tree_flatten_with_path(iw)[0]
    flat_h = [jax.tree_util.tree_flatten_with_path(i)[0] for _, i in parts]
    for (path, w), (_, h0), (_, h1) in zip(flat_w, *flat_h):
        w = np.asarray(w, np.float32)
        h = _rows(w, np.asarray(h0, np.float32), np.asarray(h1, np.float32))
        if h is not None and not np.array_equal(h, w):
            name = _dotted(path)
            differ.append((rank.get(name, len(rank)), {
                "module": name or jax.tree_util.keystr(path),
                "shape": list(w.shape), "max": float(np.abs(h - w).max()),
                "mean": float(np.abs(h - w).mean())}))
    first = min(differ, key=lambda d: d[0])[1] if differ else None
    return {"views": _stats(np.asarray(whole, np.float32), halves),
            "first_module": first}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    p.add_argument("--skip-jax", action="store_true")
    args = p.parse_args(argv)
    import torch
    torch.backends.cudnn.allow_tf32 = False
    from dynamic_multiview_3d_torch import config, weights
    from dynamic_multiview_3d_torch.api import Model
    batch = _batch()
    for dtype in args.dtypes:
        cfg = config.get_config("c2", [f"model.dtype={dtype}"])
        port, order = port_gap(cfg, batch)
        out = {"dtype": dtype, "port": port}
        if not args.skip_jax:
            params = weights.to_flax(Model.init_random(
                cfg, seed=0, device="cpu").module.state_dict())
            out["jax"] = jax_gap(config.to_dict(cfg), params, batch, order)
        out["peak_rss_gib"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
