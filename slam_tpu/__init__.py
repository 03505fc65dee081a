"""slam_tpu — batched stereo visual SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
stereo SLAM system (michaelpiro/67604-SLAM---video-navigation): stereo feature
front-end, RANSAC-PnP odometry, windowed Levenberg-Marquardt bundle adjustment
with Schur complement, pose-graph optimization, and loop closure — all batched
and shardable over device meshes.

Layer map (batched, not a port):
  ops/       pure-JAX compute kernels (SE3, stereo camera,
             triangulation, EPnP, RANSAC, features, matching, LM solvers)
  models/    pipeline stages (frontend odometry, track store, bundle
             adjustment, pose graph, loop closure)
  parallel/  jax.sharding mesh utilities; sharded/pipelined execution
  utils/     config, dataset IO (KITTI), synthetic scenes, metrics, analysis
"""

__version__ = "0.1.0"
