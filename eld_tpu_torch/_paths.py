"""Filesystem locations shared with the JAX package, found by path.

Importing any ``eld_tpu`` module imports JAX, so the port never imports
it; it reads the shipped data files (camera calibration ``.npy`` files,
the EMoR basis and calibrated CRF, the SID pair lists,
``libpatchstore.so`` and ``librawio.so``) from the
sibling ``eld_tpu/data_files`` directory.
"""

from __future__ import annotations

import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
DATA_FILES = os.path.join(REPO_ROOT, "eld_tpu", "data_files")
CAMERA_PARAMS_DIR = os.path.join(DATA_FILES, "camera_params")
EMOR_DIR = os.path.join(DATA_FILES, "emor")
PATCHSTORE_LIB = os.path.join(DATA_FILES, "native", "libpatchstore.so")
RAWIO_LIB = os.path.join(DATA_FILES, "native", "librawio.so")
PAIRS_DIR = os.path.join(DATA_FILES, "pairs")
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "eld_tpu_torch")
