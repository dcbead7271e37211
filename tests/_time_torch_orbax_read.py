"""Time the port's Orbax reader (train/orbax.py, zstd via
csrc/zstd_decode.cpp) on the full-width c2 preset params as the JAX package
writes them (zstd level 1 chunks, mostly Huffman-coded literals), beside
tensorstore's read of the same directory. A CPU measurement: the JAX
package and tensorstore run on no GPU machine of this project.

    JAX_PLATFORMS=cpu python tests/_time_torch_orbax_read.py [--repeats 3]

Prints one JSON line: the params, the directory's bytes, the zarr chunks'
decoded bytes, and the best of ``--repeats`` reads in seconds (the port's
and tensorstore's) with the port's decoded MB/s and the host's CPU count.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from _make_torch_orbax_goldens import ts_read
    from dynamic_multiview_3d_torch import config as tconfig
    from dynamic_multiview_3d_torch import weights
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.train import orbax
    from dynamic_multiview_3d_tpu import config as jconfig
    from dynamic_multiview_3d_tpu.train import checkpoint as jckpt

    model = Model.init_random(tconfig.get_config("c2"), seed=0, device="cpu")
    tree = weights.to_flax(model.module.state_dict())
    n_params = sum(v.size for v in jax.tree.leaves(tree))
    with tempfile.TemporaryDirectory() as tmp:
        jckpt.save_model(tmp, jax.tree.map(jnp.asarray, tree),
                         jconfig.get_config("c2"), step=0)
        path = os.path.join(tmp, "params_0")
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(path) for f in fs)

        def best(fn):
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                out = fn(path)
                times.append(time.perf_counter() - t0)
            return min(times), out

        ours_s, ours = best(orbax.read_orbax)
        ts_s, ref = best(ts_read)
    assert sorted(ours) == sorted(ref)
    assert all(np.array_equal(ours[k], np.asarray(ref[k])) for k in ref)
    decoded = sum(v.nbytes for v in ours.values())
    print(json.dumps({
        "preset": "c2", "params": int(n_params), "dir_bytes": nbytes,
        "decoded_bytes": decoded, "port_read_s": ours_s,
        "port_decoded_mb_per_s": decoded / ours_s / 1e6,
        "tensorstore_read_s": ts_s, "repeats": args.repeats,
        "cpus": os.cpu_count(), "device": "cpu"}))


if __name__ == "__main__":
    main()
