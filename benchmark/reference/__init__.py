"""Plain PyTorch references the port is held to; they import nothing of
the port and work from the configurations' frozen tables alone.

The harness finds a reference by the name a file gives it, as it finds a
metric's reader: benchmark/reference/<name>.py.

  code reference     named by a configuration's "reference" key; holds
                     load(path) -> table (with n, k, m, num_edges and
                     rate), check_registered(table, port_code),
                     encode(table, msg) -> codewords, and
                     llr(table, cw, noise, ebn0_db, precision="f32")
  decoder reference  named by a traffic mix's "reference" key; holds
                     parse(spec) -> parsed (with .rule) and
                     decode(table, llr, parsed, precision="f32") ->
                     (bits, ok, iterations)

precision "bf16" is the control: the same computation with every stored
value rounded to bfloat16.
"""
