"""dynamic_multiview_3d_torch — the PyTorch / CUDA port of dynamic_multiview_3d_tpu.

The JAX package beside this one is the reference; this package mirrors its
module layout and names so each piece has an obvious counterpart, and imports
nothing of it (nor jax/flax/orbax).

Layout:
    kernels/   hand-written Hopper kernels (CUDA C++ in csrc/) + plain versions
    ops/       pose math and plain bilinear sampling (the kernels' oracle)
    models/    nn.Modules: Encoder, PoseBottleneck, Decoder, ConvGRU, DMV3D
    data/      numpy synthetic scene renderer, in-step preprocessing
    train/     losses, PSNR/SSIM, the train step (init_state, make_train_step)
    weights    flax param tree <-> torch state_dict
    api        Model.init_random / from_flax_params / predict
    serving    torch.export artifacts: export_predict / ServedModel

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no GPU is present rather than falling back.
"""

from dynamic_multiview_3d_torch import config

__version__ = "0.1.0"

__all__ = ["config", "Model", "__version__"]


def __getattr__(name):
    if name == "Model":
        from dynamic_multiview_3d_torch import api
        return api.Model
    raise AttributeError(name)
