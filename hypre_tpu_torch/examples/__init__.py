"""hypre's examples on the port, each a ``main(...)`` with the signature
and return value of its counterpart in the repository's ``examples/``
(the reference's, on hypre_tpu).  Each runs on the configured device:
the card by default, the CPU after ``set_config(Config(device="cpu"))``.

    python -m hypre_tpu_torch.examples.ex15_ams

ex5 (IJ + AMG-PCG), ex11 (LOBPCG + AMG), ex_struct (CG + PFMG), ex3_pfmg
(PFMG alone), ex15_ams (AMS-PCG), ex9_systems (systems AMG-GMRES),
ex_lobpcg (LOBPCG, analytic eigenvalues), ex6_multibox (PFMG on an
L-shaped box union), ex_capi (the HYPRE_* call surface) and
ex_multichip (ParBoomerAMG-PCG over shards, with ``dryrun_multichip``,
the analog of the repository's ``__graft_entry__.dryrun_multichip``)."""
