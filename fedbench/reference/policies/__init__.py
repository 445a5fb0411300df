"""The reference of each server policy, one module a policy, named as the
mix names it (``policy``). Each module gives

- ``versions_after(n, mix)``: the global updates after ``n`` receives
  (every policy here updates on a count of receives);
- ``sketcher(model, world, mix, device, dtype)``: the client sketch the
  policy reads, or ``None``;
- ``Server(w0, mix, sketcher)``: the policy in plain PyTorch, one receive
  at a time (``receive``, ``client_sketch``, ``w``, ``version``, ``log``);
- ``NUMBERS`` and ``judge(ctx, version, receives, out, prefix)``: the
  numbers that judge one global update of a record from the record's own
  state (``fedbench.check``), each the worst over the judged updates
  (``prefix`` ``late_`` past the mix's first range of them).
"""
