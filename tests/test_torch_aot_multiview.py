"""Exported serving for the MultiView teacher (image + render ring), on the
CPU: its artifact in f32, bf16 and int8 against the eager port and the
CLI's round trip (tests/torch_aot_cases.py says what the checks hold;
against JAX's in test_torch_aot_multiview_jax.py, a module of its own so
that each stays short on one xdist worker).
"""

import pytest

import torch_aot_cases as cases
from torch_aot_cases import artifact  # noqa: F401  (the module's artifacts, a fixture)
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

FAMILY = "MultiView"


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_serves_any_batch_as_the_eager_port(artifact, dtype):
    cases.check_against_eager(FAMILY, dtype, *artifact(dtype))


@pytest.mark.parametrize("extra", [["--tour", "1"]])
def test_inference_cli_export_then_load(extra, tmp_path):
    """A tour-1 artifact served without --tour: the artifact's ring."""
    cases.check_cli(FAMILY, extra, cases.cli_files(FAMILY, tmp_path))
