"""Operator builders, one file per kind of configuration, found by the
``builder`` key of ``configs/<config>.json``. Each makes the program's
operators on the device from the configuration's sizes and the seed, and
says what the plain reference gets of them (``raw``)."""
