"""Distribution substrate for integer training (port of ``repro.parallel``).

``dp`` is the wired path: data-parallel ``les.train_step`` over ranks of
``torch.distributed``, bitwise the single-device step at any rank count
(integer gradients sum exactly).  ``sharding`` maps logical axis names to
mesh axes (the batch rule the DP step reads), ``collectives`` provides the
hand-scheduled ring all-reduce over point-to-point sends, ``compress`` the
exact int8-limb wire format (plus the approximate EF path for float
gradients).  ``tree`` walks the nested dicts, tuples and NamedTuples that
hold the step's tensors.
"""
