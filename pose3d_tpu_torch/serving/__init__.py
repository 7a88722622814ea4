"""Serving: post-training int8 quantization and exported artifacts. Port of
`pose3d_tpu/serving`.

`quant_student` quantizes the student's VGG trunk; `quant_teacher` the
teachers' ResNets (the PointCloud teacher's ResNet-50, the MultiView
teacher's ResNet-50 and per-view ResNet-18, the vanilla teacher's
ResNet-18). Their int8 products run in `ops.int8_conv`'s kernel on the
card and its plain version on the CPU. `aot` exports the student and the
PointCloud and MultiView teachers, in f32, bf16 or int8, through
`torch.export` into one batch-polymorphic file, and serves it on the card
or the CPU.

The names load on first use (PEP 562), so that `serving.aot` serves a
saved artifact without importing the models.
"""

import importlib

_NAMES = {
    "quant_student": ("load_quantized", "quantize_student", "save_quantized",
                      "student_int8_infer"),
    "quant_teacher": ("load_quantized_teacher", "make_teacher_int8_infer",
                      "make_teacher_int8_kd_fwd", "make_vanilla_int8_kd_fwd", "quantize_resnet",
                      "quantize_teacher_mv", "quantize_teacher_resnet",
                      "quantize_teacher_vanilla", "resnet50_int8_forward",
                      "resnet_int8_forward"),
}
_WHERE = {name: module for module, names in _NAMES.items() for name in names}
__all__ = ["aot", "quant_student", "quant_teacher", *_WHERE]


def __getattr__(name):
    if name in ("aot", *_NAMES):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
