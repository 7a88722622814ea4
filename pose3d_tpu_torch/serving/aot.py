"""Exported serving artifacts through `torch.export`. Port of
`pose3d_tpu/serving/aot.py`.

An artifact bakes the trained weights (or the int8 tree) and the decoded
forward into one file that `load_serving(path, device)` serves:

  * batch-polymorphic: every input shares one symbolic batch dimension
    (`torch.export.Dim`), exported at a batch of `EXAMPLE_BATCH`, not 1, so
    that batch 1 is not specialised; one file serves any batch from 1 to
    `MAX_ROWS` (65,535; the MultiView teacher's 5,461, its 12 renders a
    sample each a row of its render encoder);
  * one file for the card and the CPU: the weights are saved on the CPU
    (`torch.export.passes.move_to_device_pass`) and moved to the device
    the loader asks for, as JAX's artifact is lowered for ("cpu", "tpu");
  * its own geometry: the family, the dtype, the per-sample input shapes
    and the render ring's `tour` ride in the file (`META`), so a consumer
    preprocesses to the artifact's sizes, not to the flags that made it.

The stem, the eval PointNet and the int8 convolution are custom ops
(`pose3d_torch::vgg_stem_serve`, `::pointnet_eval`, `::pointnet_eval_bf16`,
`::int8_conv`): the exported graph holds them whole, their CUDA kernels the
port's hand kernels and their CPU kernels the plain versions. Unlike JAX's
StableHLO artifact, the port's needs those ops registered where it is
loaded: this module imports `pose3d_tpu_torch.ops` (not the models), and
that is all serving needs besides torch.

Every serving family is an `nn.Module` whose forward gives the decoded
viewpoints (b, 3) in float32 (`geometry.decode_predictions_inference`):
`student_decode_fn`, `student_int8_decode_fn`, `teacher_decode_fn` and
`teacher_int8_decode_fn`.

CLI surface: `cli/inference.py --export_aot` / `--load_aot`.
"""

from __future__ import annotations

import json
import warnings
import zipfile

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from pose3d_tpu_torch import geometry
from pose3d_tpu_torch.ops import int8_conv, pointnet, vgg_stem  # noqa: F401  (the ops)

#: the batch the graph is traced at: not 0 or 1, which torch.export specialises
EXAMPLE_BATCH = 2
#: the most rows a call of PyTorch's CUDA eval BatchNorm takes on cuDNN's
#: path (`_batch_norm_impl_index`): tracing on the card guards on it, so an
#: artifact serves batches of 1 to MAX_ROWS // (rows a sample)
MAX_ROWS = 65535
#: the extra file that marks the port's artifact and holds its geometry
META = "pose3d_serving.json"
FORMAT = "pose3d_tpu_torch serving artifact (torch.export .pt2)"


def _decode(outputs, bin_size) -> torch.Tensor:
    outputs = [o.float() for o in outputs]
    return geometry.decode_predictions_inference(outputs[:3], outputs[3:], bin_size)


class _Tree(nn.Module):
    """A quantized tree's tensors as buffers (so that the export lifts and
    saves them), rebuilt into the tree's dicts and lists by `tree()`."""

    def __init__(self, tree):
        super().__init__()
        self._skeleton = self._store(tree, "q")

    def _store(self, node, path):
        if isinstance(node, dict):
            return {k: self._store(v, f"{path}_{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(self._store(v, f"{path}_{i}") for i, v in enumerate(node))
        # a copy of its own, in the leaf's layout: a leaf can share its
        # storage with the model's parameters (quantize_* reads them through
        # numpy), which the saved file would hold as one partial group; a
        # transposed leaf stays transposed, so its products take the eager
        # forward's GEMM
        self.register_buffer(path, node.clone())
        return path

    def tree(self, node=None):
        node = self._skeleton if node is None else node
        if isinstance(node, dict):
            return {k: self.tree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(self.tree(v) for v in node)
        return getattr(self, node)


class _StudentDecode(nn.Module):
    def __init__(self, model: nn.Module, bin_size: int):
        super().__init__()
        self.model, self.bin_size = model, bin_size

    def forward(self, x):
        return _decode(self.model(x)[0], self.bin_size)


class _TeacherDecode(_StudentDecode):
    def forward(self, x, shape):
        return _decode(self.model(x, shape)[0], self.bin_size)


class _StudentInt8Decode(nn.Module):
    def __init__(self, q: dict, bin_size: int, dtype: torch.dtype):
        super().__init__()
        self.q, self.bin_size, self.dtype = _Tree(q), bin_size, dtype

    def forward(self, x):
        from pose3d_tpu_torch.serving.quant_student import student_int8_infer

        return _decode(student_int8_infer(self.q.tree(), x, self.dtype), self.bin_size)


class _TeacherInt8Decode(nn.Module):
    """The int8 teacher's serving forward. It holds what that forward reads
    of the teacher (DeformNet, the heads and, for PointCloud, the shape
    encoder) and the int8 tree, not the float ResNets the tree replaces."""

    def __init__(self, teacher: nn.Module, q: dict, bin_size: int):
        super().__init__()
        from pose3d_tpu_torch.models.estimators import HEADS
        from pose3d_tpu_torch.models.pointnet import ShapeEncoderPC

        self.compute_dtype, self.bin_size = teacher.compute_dtype, bin_size
        self.deformNet = teacher.deformNet
        for name in HEADS:
            setattr(self, name, getattr(teacher, name))
        if isinstance(teacher.shape_encoder, ShapeEncoderPC):
            self.shape_encoder = teacher.shape_encoder
        self.q = _Tree(q)

    def forward(self, x, shape):
        from pose3d_tpu_torch.serving.quant_teacher import make_teacher_int8_infer

        return _decode(make_teacher_int8_infer(self)(self.q.tree(), x, shape), self.bin_size)


def student_decode_fn(model: nn.Module, bin_size: int) -> nn.Module:
    """images (b, H, W, 3) f32 -> decoded viewpoints (b, 3) f32: the
    student's (`BaselineEstimator`, f32 or bf16 compute) eval forward and
    the inference decoder, as the inference CLI serves it."""
    return _StudentDecode(model, bin_size)


def student_int8_decode_fn(q: dict, bin_size: int,
                           dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The int8 variant of `student_decode_fn`: the quantized tree
    (`quantize_student`) as buffers, served in `dtype` (bfloat16, JAX's
    default)."""
    return _StudentInt8Decode(q, bin_size, dtype)


def teacher_decode_fn(model: nn.Module, bin_size: int) -> nn.Module:
    """(images (b, H, W, 3), shape input) -> decoded viewpoints (b, 3): the
    teacher's eval forward and the inference decoder. The shape input,
    clouds (b, P, 3) for PointCloud or renders (b, K, h, w, 3) for
    MultiView, is exported beside the image."""
    return _TeacherDecode(model, bin_size)


def teacher_int8_decode_fn(teacher: nn.Module, q: dict, bin_size: int) -> nn.Module:
    """The int8 variant of `teacher_decode_fn` (`make_teacher_int8_infer`):
    q from `quantize_teacher_resnet` (PointCloud) or `quantize_teacher_mv`
    (MultiView), the rest in the teacher's dtype."""
    return _TeacherInt8Decode(teacher, q, bin_size)


def export_fn(fn: nn.Module, per_sample_shapes, *, dtypes=None,
              device: torch.device | str | None = None) -> torch.export.ExportedProgram:
    """Export `fn(*inputs) -> preds` with the batch dimension symbolic.

    `per_sample_shapes`: one shape per input, without the batch dimension;
    all inputs share one symbolic batch, of 1 to MAX_ROWS over the rows a
    sample gives the encoders (the K renders of a (K, h, w, 3) input, else
    1). Traced (non-strict, without gradients) on `device`, by default that
    of fn's first parameter or buffer; the weights are lifted into the
    program."""
    if device is None:
        device = next(iter([*fn.parameters(), *fn.buffers()])).device
    dtypes = dtypes or (torch.float32,) * len(per_sample_shapes)
    rows = max([s[0] for s in per_sample_shapes if len(s) == 4], default=1)
    batch = torch.export.Dim("b", min=1, max=MAX_ROWS // rows)
    args = tuple(torch.zeros((EXAMPLE_BATCH, *s), dtype=d, device=device)
                 for s, d in zip(per_sample_shapes, dtypes))
    with torch.no_grad():
        return torch.export.export(fn.eval(), args, dynamic_shapes=tuple(
            {0: batch} for _ in args), strict=False)


def export_serving(fn: nn.Module, input_dim: int, *,
                   device: torch.device | str | None = None) -> torch.export.ExportedProgram:
    """Export the single-input `fn(images) -> preds` (the student paths)."""
    return export_fn(fn, ((input_dim, input_dim, 3),), device=device)


def _user_inputs(program: torch.export.ExportedProgram):
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in names]


def save_serving(program: torch.export.ExportedProgram, path: str, *, kind: str,
                 dtype: str, tour: int | None = None) -> None:
    """Write `program` with its geometry: kind ("student", "PointCloud" or
    "MultiView"), dtype ("f32", "bf16" or "int8"), the per-sample input
    shapes and the MultiView ring's `tour`. The program is moved to the CPU
    (in place) first, so the file loads on any device."""
    meta = {"kind": kind, "dtype": dtype, "tour": tour,
            "in_shapes": [[int(s) for s in v.shape[1:]] for v in _user_inputs(program)]}
    with warnings.catch_warnings():
        # a transposed int8 leaf (_Tree) is its storage's only tensor but no
        # contiguous one, which the writer warns of; it is saved on the CPU
        # with its strides, which is what the warning asks for
        warnings.filterwarnings("ignore", "No complete tensor found in the group")
        with open(path, "wb") as f:  # a file object: any name, not only *.pt2
            torch.export.save(move_to_device_pass(program, "cpu"), f,
                              extra_files={META: json.dumps(meta)})


class ServingArtifact:
    """A loaded artifact on its device: call it on numpy or torch batches
    (float32 is what it takes); it returns the (b, 3) viewpoints, float32,
    on that device."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict,
                 device: torch.device):
        self.device = device
        self.kind, self.dtype, self.tour = meta["kind"], meta["dtype"], meta["tour"]
        # per-input shapes without the batch: the artifact's own geometry;
        # the second one's rank tells the teachers apart, (P, 3) clouds
        # against (K, h, w, 3) renders
        self.in_shapes = tuple(tuple(s) for s in meta["in_shapes"])
        self.input_dim = self.in_shapes[0][0]
        self.n_inputs = len(self.in_shapes)  # 1 the student, 2 a teacher
        self.program, self._module = program, program.module()

    def __call__(self, *inputs) -> torch.Tensor:
        tensors = [torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()
                   for x in inputs]
        with torch.no_grad():
            return self._module(*tensors)


def load_serving(path: str, device: torch.device | str = "cpu") -> ServingArtifact:
    """Load an artifact of `save_serving` onto `device`. A file that is not
    one (JAX's serialized StableHLO, a checkpoint) is refused."""
    refused = (f"{path}: not a {FORMAT}; JAX's StableHLO artifacts load with "
               "pose3d_tpu.serving.aot")
    if not zipfile.is_zipfile(path):  # JAX's artifact: serialized StableHLO
        raise ValueError(refused)
    extra = {META: ""}
    try:
        with open(path, "rb") as f:
            program = torch.export.load(f, extra_files=extra)
    except RuntimeError as e:  # another zip, such as a torch.save checkpoint
        raise ValueError(f"{refused} ({e})") from e
    if not extra[META]:
        raise ValueError(f"{path}: a torch.export program without {META}, not a {FORMAT}")
    device = torch.device(device)
    return ServingArtifact(move_to_device_pass(program, device), json.loads(extra[META]),
                           device)
