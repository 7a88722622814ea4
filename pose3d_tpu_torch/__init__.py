"""pose3d_tpu_torch — the PyTorch and CUDA port of pose3d_tpu, for NVIDIA Hopper.

Each module keeps the name of its JAX counterpart in `pose3d_tpu`, which
stays the reference the port is tested against. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a CUDA kernel written
by hand for sm_90a (`csrc/`), built at first use (`ops/_build.py`) and
launched by a wrapper that keeps the plain PyTorch version beside it for
CPU tensors.

Ported so far: every model (the RGB-only student, the PointCloud and
MultiView teachers, the vanilla teacher; `models`), their evaluation and
serving (`train.steps`, `train.evaluate`, `cli.testing`, `cli.inference`),
every training regime (`cli.training`: the contrastive teacher and the
RGB-only baseline; `cli.trainingKD`: KD `--crd`, `--contrast`, `--vid`,
`--stage 1` with the memory bank, `--stage 2`), every dataset, `--bf16`,
int8 serving (`serving`), exported serving (`serving.aot`), the on-device
data options (`ops.shape_bank`, `ops.augment`) and the host data options
(`data.shm_loader`, `data.decode_cache`, the native PLY reader of
`data.ply`, the trainers' `--profile_dir`). Each Pallas kernel of the JAX
package runs in a CUDA kernel on the card: the geodesic error
(`ops.geodesic`), the eval and train-mode PointNets (`ops.pointnet`,
`ops.pointnet_train`), the infoNCE (`ops.nce`) and the student's VGG stem
(`ops.vgg_stem`); the int8 convolution (`ops.int8_conv`) replaces XLA's.
Still to port: multi-GPU and the library surface (ROADMAP.md Queue 1).

Importing the package imports nothing: the data layer needs PIL and pandas
(and a host C++ compiler for the PLY reader), and the kernels need a card
and nvcc, so each is loaded where it is used.
"""

__version__ = "0.1.0"
