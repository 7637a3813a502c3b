"""Command-line entry points of the port, each run as
``python -m obvi_slam_tpu_torch.cli.<name>`` and each with ``main(argv=None)
-> int``. They read and write the reference's file formats
(``obvi_slam_tpu_torch.io``) and take ``--device`` (default ``cuda``; pass
``cpu`` to run on the CPU):

  - ``offline_object_visual_slam_main``  one object-visual session;
  - ``sequence_executor``                sessions chained through the LTM;
  - ``run_opt_from_pg_state``            resume a session from a checkpoint;
  - ``ltm_extraction_only``              the LTM from a checkpoint;
  - ``debug_jacobian_hessian_diagonal``  the Jacobian and Hessian-diagonal
                                         report of a checkpoint;
  - ``trajectory_metrics_generator``,    ATE/RPE and object-map metrics of
    ``object_metrics_generator``         a session's results;
  - ``write_configuration``              the default config as JSON.
"""
