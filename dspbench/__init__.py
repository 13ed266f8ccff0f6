"""The benchmark of the PyTorch/CUDA port (``semantic_dsp_map_tpu_torch``):
``python3 -m dspbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card (``run``); ``harness`` the
run, ``traffic`` the scene generator, ``reference`` the frozen plain step,
``check`` the output comparison, ``trace`` the profiled slice, ``census``
the kernels' bytes; ``configs/``, ``traffic/``, ``metrics/`` and
``limits/`` hold one file a configuration, mix, metric and cell."""
