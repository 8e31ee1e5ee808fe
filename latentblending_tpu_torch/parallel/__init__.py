"""The multi-GPU layer: process group start-up (distributed.py), the
('data', 'model') mesh and its collectives (mesh.py), and Megatron tensor
parallelism of the UNet's transformer blocks (tp.py). Counterpart of
latentblending_tpu/parallel/."""
