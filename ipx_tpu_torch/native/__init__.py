"""The port's native host library: ipxlu.cc (sparse LU, hypersparse solves,
native CR, the IPM's vector passes), built by build.py and bound with ctypes
by basis/lu.py and veckernels.py."""
