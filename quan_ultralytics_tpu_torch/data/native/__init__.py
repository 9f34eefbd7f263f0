"""Host-side image reading and writing in C++ and numpy (see native.py)."""
