"""`tmp_path` for the port's tests that write checkpoints or run dirs: the
same directory, deleted after the test. A full checkpoint of the network
is about 300 MB and pytest keeps the temporary directories of its last
three runs, so without this a whole run leaves gigabytes behind.

    from torch_cleanup import tmp_path  # noqa: F401
"""

import shutil

import pytest


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
