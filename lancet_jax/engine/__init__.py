"""Oracle engine: exact host-side implementation of the reference semantics.

Defines correctness for the device engine (every kernel is validated against
this) and serves as the fallback path for irregular windows.
"""
