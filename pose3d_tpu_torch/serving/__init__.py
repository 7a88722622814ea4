"""Serving: post-training int8 quantization. Port of `pose3d_tpu/serving`
(its `aot` module is not ported: ROADMAP.md).

`quant_student` quantizes the student's VGG trunk; `quant_teacher` the
teachers' ResNets (the PointCloud teacher's ResNet-50, the MultiView
teacher's ResNet-50 and per-view ResNet-18, the vanilla teacher's
ResNet-18). Their int8 products run in `ops.int8_conv`'s kernel on the
card and its plain version on the CPU.
"""

from pose3d_tpu_torch.serving.quant_student import (  # noqa: F401
    load_quantized,
    quantize_student,
    save_quantized,
    student_int8_infer,
)
from pose3d_tpu_torch.serving.quant_teacher import (  # noqa: F401
    load_quantized_teacher,
    make_teacher_int8_infer,
    make_teacher_int8_kd_fwd,
    make_vanilla_int8_kd_fwd,
    quantize_resnet,
    quantize_teacher_mv,
    quantize_teacher_resnet,
    quantize_teacher_vanilla,
    resnet50_int8_forward,
    resnet_int8_forward,
)
