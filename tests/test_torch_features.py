"""BSC descriptors and the Hamming feature distance of both packages at the
same keypoints of one structured scene."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.core.types import compact_device as j_compact
from ghicp_tpu.features import extract_bsc as j_extract
from ghicp_tpu.features import min_hamming_fd as j_fd
from ghicp_tpu.features import unpack_bits as j_unpack
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.preprocess import detect_keypoints as j_detect
from ghicp_tpu.preprocess import voxel_downsample as j_voxel
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.bsc import (extract_bsc, pack_bits,
                                          sample_pattern, unpack_bits)
from ghicp_tpu_torch.features.hamming import min_hamming_fd

torch.set_num_threads(1)
CFG = dict(voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
           min_neighbors=8)


@pytest.fixture(scope="module")
def keypoints():
    """A downsampled scene and 256 keypoint slots (JAX-detected)."""
    pts = structured_scene(np.random.default_rng(0), 8000, extent=10.0)
    jd = j_compact(j_voxel(JCloud.from_points(pts), CFG["voxel_size"]))
    km = np.asarray(j_detect(jd, JConfig(**CFG)).mask)
    idx = np.nonzero(km)[0][:256]
    kp = np.zeros((256, 3), np.float32)
    kp[:len(idx)] = np.asarray(jd.xyz)[idx]
    kmask = np.zeros(256, bool)
    kmask[:len(idx)] = True
    return jd, kp, kmask


@pytest.fixture(scope="module")
def features(keypoints):
    jd, kp, kmask = keypoints
    out = {}
    for v in (4, 1):
        jf = j_extract(jd, jnp.asarray(kp), jnp.asarray(kmask),
                       JConfig(**CFG), num_variants=v)
        cloud = PointCloud(xyz=torch.tensor(np.asarray(jd.xyz)),
                           mask=torch.tensor(np.asarray(jd.mask)))
        tf = extract_bsc(cloud,
                         torch.from_numpy(kp), torch.from_numpy(kmask),
                         GHICPConfig(**CFG), num_variants=v)
        out[v] = (jf, tf)
    return out


def test_sample_pattern_and_packing():
    from ghicp_tpu.features import pack_bits as j_pack
    from ghicp_tpu.features import sample_pattern as j_pattern
    assert np.array_equal(sample_pattern(20170417, 7),
                          np.asarray(j_pattern(20170417, 7)))
    bits = (np.random.default_rng(2).random((5, 441)) < 0.4)
    mine = pack_bits(torch.from_numpy(bits))
    theirs = np.asarray(j_pack(jnp.asarray(bits.astype(np.float32))))
    assert np.array_equal(mine.numpy(), theirs.astype(np.int64))
    assert np.array_equal(unpack_bits(mine, 441).numpy(),
                          bits.astype(np.float32))


@pytest.mark.parametrize("variants", [4, 1])
def test_bsc_bits(features, keypoints, variants):
    _, _, kmask = keypoints
    jf, tf = features[variants]
    jb = np.asarray(j_unpack(jf.packed, jf.n_bits))[:, kmask]
    tb = unpack_bits(tf.packed, tf.n_bits).numpy()[:, kmask]
    assert jb.shape == tb.shape and tb.shape[-1] == 441
    assert np.mean(jb == tb) >= 0.99
    assert np.all(unpack_bits(tf.packed, tf.n_bits).numpy()[:, ~kmask] == 0)
    # frames: rows are orthonormal right-handed axes
    fr = tf.frames.numpy()[kmask]
    np.testing.assert_allclose(fr @ fr.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), fr.shape),
                               atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(fr), 1.0, atol=1e-4)


def test_min_hamming_fd(features):
    (js, ts), (jt, tt) = features[4], features[1]
    # identical packed inputs: identical (exact integer) distances
    fd_same = min_hamming_fd(
        torch.from_numpy(np.asarray(js.packed).astype(np.int64)),
        torch.from_numpy(np.asarray(jt.packed).astype(np.int64)), 441)
    fd_j = np.asarray(j_fd(js.packed, jt.packed, 441))
    assert np.array_equal(fd_same.numpy(), fd_j)
    # each package's own descriptors: distances agree to a few bits
    fd_t = min_hamming_fd(ts.packed, tt.packed, 441).numpy()
    assert np.mean(np.abs(fd_t - fd_j)) <= 0.02 * 441
