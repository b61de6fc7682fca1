"""Kinds of input, one file each, named by a mix's ``inputs`` key. Each has
``FRESH`` (True where every solve draws inputs of its own, False where
solves share a pool of operators and differ only in which they take) and
``draw(mix, seed, index, n, dtype, device)``, which gives solve ``index``'s
``(operator index, keyword arguments of the call)``. The same arguments go
to the plain reference after the window, and to the control. A mix that
needs another kind of input (a start block, a shift) adds a file here."""
