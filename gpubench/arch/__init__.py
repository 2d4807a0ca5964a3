"""A family's sizes and weights: ``arch/<family>.py`` for the family a
configuration file names under ``reference``.

It defines ``sizes(config)`` (an object with at least ``vocab``,
``n_layers`` and ``dtype``, which the traffic, the weights and the checks
read), ``layer_shapes(a, i)`` (layer ``i``'s weights: name -> (shape,
fan_in or None for a gain of ones, dtype), in the order they are drawn),
``global_shapes(a)`` (the weights outside the layers: name -> (shape, std
or None for ones, dtype)), ``port_name(name)`` (the program's parameter
of a benchmark weight, ``blocks.<i>.<name>`` within a layer),
``check_config(config)`` (raises ``ValueError`` on a file the family
cannot describe) and ``tiny(config)`` (the keys that cut the
configuration to a CPU test's size). Plain Python: imports nothing of
the program.
"""
