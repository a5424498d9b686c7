"""Host native code of the port: the augmentation operators (`augment.cpp`),
built with g++ at first use and bound with ctypes (`augment_lib.py`)."""
