"""Seed-patch generation from images (reference C9: TMVS/mvs/featuremanager).

The PyTorch counterpart of ``pais_mvs_tpu/features/``, replacing the
reference's OpenCV SIFT + brute-force matcher
(TMVS/mvs/featuremanager.cpp:5-116):

* ``detect``    — DoG scale-space keypoints from blurs and 3x3 pooling.
* ``describe``  — gradient-histogram descriptors on fixed sample grids.
* ``matching``  — all-pairs descriptor matching as one matmul per view
                  pair, cross-checked and epipolar-gated with analytic
                  fundamental matrices.
* ``seeding``   — n-view track union (host) + ray triangulation into seed
                  patches.
"""

from pais_mvs_tpu_torch.features.seeding import generate_seed_patches  # noqa: F401
