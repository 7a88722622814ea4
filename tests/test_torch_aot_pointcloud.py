"""Exported serving for the PointCloud teacher (image + cloud; the eval
PointNet's op), on the CPU: its artifact in f32, bf16 and int8 against the
eager port and against JAX's, and the CLI's round trip
(tests/torch_aot_cases.py says what the checks hold).
"""

import pytest

import torch_aot_cases as cases
from torch_aot_cases import artifact  # noqa: F401  (the module's artifacts, a fixture)
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

FAMILY = "PointCloud"


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_serves_any_batch_as_the_eager_port(artifact, dtype):
    cases.check_against_eager(FAMILY, dtype, *artifact(dtype))


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_matches_jax(artifact, dtype, tmp_path):
    cases.check_against_jax(FAMILY, dtype, artifact(dtype)[0], tmp_path)


@pytest.mark.parametrize("extra", [["--bf16"]])
def test_inference_cli_export_then_load(extra, tmp_path):
    cases.check_cli(FAMILY, extra, cases.cli_files(FAMILY, tmp_path))
