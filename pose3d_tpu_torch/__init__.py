"""pose3d_tpu_torch — the PyTorch and CUDA port of pose3d_tpu, for NVIDIA Hopper.

Each module keeps the name of its JAX counterpart in `pose3d_tpu`, which
stays the reference the port is tested against. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a CUDA kernel written
by hand for sm_90a (`csrc/`), built at first use (`ops/_build.py`) and
launched by a wrapper that keeps the plain PyTorch version beside it for
CPU tensors.

Ported so far: the RGB-only student (slice 1) and the frozen PointCloud
teacher (slice 2) (`models`), their evaluation (`train.steps`,
`train.evaluate`, `cli.testing`) and single-image serving
(`cli.inference`), the teacher's contrastive training (slice 3,
`cli.training`) and the student's KD `--crd` training (slice 4,
`cli.trainingKD`), with the geodesic rotation error (`ops.geodesic`), the
teacher's PointNet encoder (`ops.pointnet`), the in-batch infoNCE
(`ops.nce`) and the student's VGG stem (`ops.vgg_stem`) in CUDA kernels on
the card.

Importing the package imports nothing: the data layer needs PIL and pandas,
and the kernels need a card and nvcc, so each is loaded where it is used.
"""

__version__ = "0.1.0"
