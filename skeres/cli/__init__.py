"""Console entry points (reference: the gflags example binaries —
``examples/bundle_adjuster.cc``, ``examples/slam/pose_graph_{2d,3d}`` in the
Ceres lineage). Run as modules:

    python -m skeres.cli.bundle_adjuster --input data/problem-49.txt \
        --linear_solver DENSE_SCHUR --robustify
    python -m skeres.cli.pose_graph_3d --num_poses 2500
    python -m skeres.cli.pose_graph_2d --input graph.g2o
"""
