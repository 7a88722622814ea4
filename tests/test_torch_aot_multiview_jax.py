"""Exported serving for the MultiView teacher (image + render ring), on the
CPU: its artifact in f32, bf16 and int8 against JAX's for the same weights
(tests/torch_aot_cases.py says what the check holds; the eager port and the
CLI in test_torch_aot_multiview.py).
"""

import pytest

import torch_aot_cases as cases
from torch_aot_cases import artifact  # noqa: F401  (the module's artifacts, a fixture)
import torch_xdist_threads  # noqa: F401  (torch's threads under pytest-xdist)
from torch_xdist_threads import release_module_memory  # noqa: F401

FAMILY = "MultiView"


@pytest.mark.parametrize("dtype", cases.DTYPES)
def test_artifact_matches_jax(artifact, dtype, tmp_path):
    cases.check_against_jax(FAMILY, dtype, artifact(dtype)[0], tmp_path)
