"""Device meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

``repro``'s ``make_production_mesh`` lays out TPU v5e pods (256 chips as
(data 16, model 16), two pods with a leading "pod" axis); it has no H100
counterpart here. A mesh is a ``DeviceMesh`` over an initialized default
process group whose ranks are laid out row-major (``init_device_mesh``).
"""

from __future__ import annotations


def make_test_mesh(data: int = 2, model: int = 2,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the default process group, which must
    have ``data * model`` ranks: NCCL on the card, gloo with
    ``device_type="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))
