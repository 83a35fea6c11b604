"""Front doors of the program, one module each, found by the ``door`` a
traffic mix names. A module's ``make(program, cfg, mix, seed, device)``
returns an object with ``answer`` (``"distance"`` or ``"span"``: what a
call returns, which sets the instructions a cell needs), ``warm_up()``,
``call(i)`` (the i-th call of the closed loop, returning once its
answers are on the host: ``(record, cells)``) and
``check(records, seed, lanes=32)``: ``{name: (value, limit)}``, the
program's records against the plain reference, or with ``lanes=16`` the
control's answers put in their place. ``FAULTS`` lists faults that a
run of the door's path can have, each a function that plants itself in
the program with ``patch(owner, name, value)``."""
