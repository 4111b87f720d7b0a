"""The port of experiments/: the probes that split a decoder's time.

Six scripts, each named as its TPU counterpart and run as
`python -m ecc_ldpc_tpu_torch.experiments.<name>` (on the card; with
`--device cpu` the plain versions run on the host):

  ablate_layered    K1a's fixed-iteration layered min-sum with one cost
                    removed at a time, its tables read at run time (E1)
  ablate_layered2   the same with the tables compiled in (static rows), in
                    the throughput regime (E2)
  static_unroll     the fully static sweep against K1a (E3)
  smallcode_opt2    the dc-major flooding min-sum on mackay1008 and its two
                    ablations (E4)
  micro_vpu         the per-dtype elementwise chain and roll chain (E5, E6)
  micro_vpu2        per-op throughput by dtype with 4 independent chains (E7)

The kernels are csrc/ablate_layered.cu (E1-E3), csrc/dcmajor.cu (E4) and
csrc/micro_ops.cu (E5-E7); their wrappers and plain versions are in
ablate.py, smallcode_opt2.py and micro.py.
"""
