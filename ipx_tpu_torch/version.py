"""Version (reference: include/ipx_version.h — reference is 1.1.0; this
package tracks its own versioning starting at 0.1.0).

The port's copy of ipx_tpu/version.py.
"""
VERSION_MAJOR = 0
VERSION_MINOR = 4
VERSION_PATCH = 0
__version__ = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"
