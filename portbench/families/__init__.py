"""One module a GCC family of the program; see portbench/family.py."""
