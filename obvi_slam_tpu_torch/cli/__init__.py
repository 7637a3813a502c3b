"""Command-line entry points of the port, each run as
``python -m obvi_slam_tpu_torch.cli.<name>`` and each with ``main(argv=None)
-> int``; each is the counterpart of the JAX package's repo-root
``cli/<name>.py``, with its flags, defaults and output formats. They read and
write the reference's file formats (``obvi_slam_tpu_torch.io``). The ones
that solve take ``--device`` (default ``cuda``; pass ``cpu`` to run on the
CPU) where the JAX scripts take ``--platform``; the others only read and
write files, compute in numpy and take no device.

Sessions and their results:

  - ``offline_object_visual_slam_main``  one object-visual session
                                         (``--debug_images_output_directory``
                                         needs PIL);
  - ``sequence_executor``                sessions chained through the LTM;
  - ``single_trajectory_estimator``      the ORB preparation steps, then one
                                         session;
  - ``run_opt_from_pg_state``            resume a session from a checkpoint;
  - ``ltm_extraction_only``              the LTM from a checkpoint;
  - ``debug_jacobian_hessian_diagonal``  the Jacobian and Hessian-diagonal
                                         report of a checkpoint;
  - ``write_configuration``              the default config as JSON;
  - ``display_ltm``, ``iteration_plotter`` (needs matplotlib)  an LTM's
    objects as text, per-solve convergence plots.

Data preparation: ``orb_stereo_reformat_data``,
``initialize_traj_and_feats_from_orb_out``, ``orb_trajectory_sparsifier``,
``interpolate_poses_with_required_nodes``, ``gt_transformer``,
``utvslam_out_to_poses_by_timestamp``, ``waypoint_timestamp_extractor``,
``traj_length_evaluator``, ``sequence_file_writer``,
``convert_object_detections_from_yaml`` (needs PyYAML),
``extract_all_bounding_boxes`` (a detector worker process),
``oa_slam_data_generator``.

Evaluation and comparison: ``trajectory_metrics_generator``,
``object_metrics_generator``, ``compute_metrics_for_approach``,
``compute_metrics_for_orbslam3``, ``compute_metrics_for_droidslam``,
``compute_metrics_for_oaslam``, ``compute_metrics_for_sequence``
(``--plots_dir`` needs matplotlib), ``timing_analysis``, and the
third-party launchers ``run_comparison_system``, ``run_orb_slam_2``,
``run_multi_session_orb_slam_3``, ``run_lego_loam`` (the binaries are
configured by a command template, not bundled).
"""
