"""The host's shape rule for the W8 kernels (``ops/quant_matmul._w8_plan``):
which bf16 calls take the Hopper kernel (TMA needs K % 8 == 0, a code row
pitch that is a multiple of 16 and 16-byte aligned x and q; the kernel
stores column pairs, so N is even), how many output tiles they give and how
K is split. A pure function of shapes: no card, no kernel."""

import pytest
import torch

from kosmosx_torch.ops import quant_matmul as tqm
from kosmosx_torch.studies import w8_study

H100_SMS = 132
# the main path's W8 shapes (chip_smoke.py: decode over the decoder's and
# the vocab head's weights, prefill, CLIP's patch embedding) and the ViT's,
# the resampler's and the image projection's
DECODE_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 32002))
MAIN_SHAPES = ([(m, k, n) for m in (4, 8) for k, n in DECODE_KN]
               + [(3968, 2048, 8192), (514, 588, 1024)])
MODEL_SHAPES = [(514, 1024, 1024), (514, 1024, 4096), (514, 4096, 1024),
                (128, 1024, 1024), (128, 1024, 2048), (2048, 2048, 2048),
                (3968, 8192, 2048)]


def _plan(m, k, n, x_aligned=True, q_aligned=True, pitch=None):
    return tqm._w8_plan(m, k, n, x_aligned, q_aligned, H100_SMS, pitch)


def _padded(n):
    """The row pitch of ``utils/quantize.pitched_codes``."""
    return tqm._cdiv(n, 16) * 16


@pytest.mark.parametrize("codes", ["padded", "dense"])
@pytest.mark.parametrize("m,k,n", MAIN_SHAPES + MODEL_SHAPES)
def test_main_path_shapes_take_the_hopper_kernel(m, k, n, codes):
    """Every main-path shape takes the Hopper kernel but CLIP's patch
    embedding (K = 588), the vocab head (N = 32002) on its padded codes,
    as the port makes them, too; on dense (2048, 32002) codes, whose rows
    are 2-byte aligned, the vocab head takes the mma.sync kernel."""
    pitch = _padded(n) if codes == "padded" else None
    path, tiles, splits = _plan(m, k, n, pitch=pitch)
    mma = k == 588 or (n == 32002 and codes == "dense")
    assert path == ("mma" if mma else "hopper")
    assert tiles >= 1 and splits >= 1


@pytest.mark.parametrize("m,splits,block", [(1, 1, 64), (4, 1, 64),
                                            (8, 1, 64), (300, 1, 256),
                                            (3968, 1, 256)])
def test_vocab_head_on_padded_codes(m, splits, block):
    """(M, 2048) x (2048, 32002) with rows 32016 codes apart: 251 column
    tiles, the last of them 2 columns wide; at decode already 251 blocks
    for 264 slots, so K is not split."""
    path, tiles, got_splits = _plan(m, 2048, 32002, pitch=32016)
    assert path == "hopper" and got_splits == splits
    assert tqm._hopper_block(m, 32002, H100_SMS)[0] == block
    assert tiles == tqm._cdiv(m, block) * 251


@pytest.mark.parametrize("n,pitch", [(51, 64), (70, 72), (32002, 32008)])
def test_pitch_rule(n, pitch):
    """The pitch, not N, must be a multiple of 16, and N must be even."""
    want = "hopper" if n % 2 == 0 and pitch % 16 == 0 else "mma"
    assert _plan(4, 1024, n, pitch=pitch)[0] == want


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("k,n", [kn for kn in DECODE_KN if kn[1] != 32002])
def test_decode_splits_fill_every_sm(m, k, n):
    """At decode the 64 x 128 output tiles are few; K is split so that there
    is at least one block per SM and at most two (the kernel's occupancy)."""
    path, tiles, splits = _plan(m, k, n)
    assert path == "hopper"
    assert tiles == tqm._cdiv(n, 128)
    assert H100_SMS <= tiles * splits <= 2 * H100_SMS


@pytest.mark.parametrize("m,k,n", [(3968, 2048, 8192), (3968, 8192, 2048),
                                   (3968, 2048, 2048)])
def test_prefill_does_not_split(m, k, n):
    """256 x 128 tiles: enough of them at prefill, K whole in each block."""
    path, tiles, splits = _plan(m, k, n)
    assert path == "hopper" and splits == 1
    assert tiles == tqm._cdiv(m, 256) * tqm._cdiv(n, 128) >= H100_SMS


@pytest.mark.parametrize("x_aligned,q_aligned", [(False, True), (True, False),
                                                 (False, False)])
def test_misaligned_bases_take_the_mma_kernel(x_aligned, q_aligned):
    assert _plan(4, 2048, 8192, x_aligned, q_aligned)[0] == "mma"


@pytest.mark.parametrize("k,n", [(130, 70), (2052, 4096), (2048, 4104),
                                 (640, 1100)])
def test_ragged_shapes_take_the_mma_kernel(k, n):
    """K % 8 != 0 or N % 16 != 0 (the test shapes (5, 130, 70) and
    (300, 640, 1100) among them) keep the mma.sync kernel."""
    assert _plan(5, k, n)[0] == "mma"


@pytest.mark.parametrize("m", [1, 4, 63, 64, 65, 129, 300, 514])
@pytest.mark.parametrize("k", [8, 64, 200, 576, 1024, 4096])
def test_hopper_splits_leave_no_split_without_k(m, k):
    """The C entry gives each split cdiv(nk, splits) K tiles; the plan's
    split count is one for which every split gets some."""
    path, _, splits = _plan(m, k, 1024)
    nk = tqm._cdiv(k, 64)
    assert path == "hopper" and 1 <= splits <= nk
    assert tqm._cdiv(nk, tqm._cdiv(nk, splits)) == splits


@pytest.mark.parametrize("m", [1, 4, 8, 33, 64, 128, 256, 257, 514])
@pytest.mark.parametrize("k,n", [(1024, 1024), (2048, 8192), (8192, 2048)])
def test_split_reduction_stays_small(m, k, n):
    """The last split of an output tile adds every split's partial sums
    alone: at most 128 rows x splits of them (64 KB), so only small M
    splits K."""
    path, _, splits = _plan(m, k, n)
    assert path == "hopper"
    assert splits == 1 or min(m, tqm._hopper_block(m, n, H100_SMS)[0]) * splits <= 128


@pytest.mark.parametrize("m,n,block", [
    (1, 8192, 64), (64, 8192, 64), (65, 8192, 64), (256, 4096, 64),
    (514, 1024, 64), (514, 4096, 256), (2048, 2048, 256), (3968, 2048, 256)])
def test_hopper_block_rows(m, n, block):
    """256-row blocks where M > 64 and they give at least half the SMs a
    block, 64-row blocks elsewhere."""
    assert tqm._hopper_block(m, n, H100_SMS)[0] == block


def test_w8_study_needs_a_card(capsys):
    """Without a CUDA device the W8 study exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert w8_study.main() != 0
    assert capsys.readouterr().out == ""


def test_w8_study_patches_apply():
    """Every patched copy of the study finds the text it replaces in
    csrc/w8_matmul.cu (a kernel edit that moves it must move the patch)."""
    source = (w8_study._build.CSRC / "w8_matmul.cu").read_text()
    for name, patches in w8_study.VARIANTS.items():
        for old, _ in patches:
            assert source.count(old) == 1, (name, old)


def test_code_pitch_of_padded_dense_and_strided_codes():
    """The W8 wrapper's row pitch: the padded pitch of ``_quantize_w``'s
    ragged codes, N for dense and stacked codes; a transposed view or a
    stack whose layers are not K rows apart raises."""
    from kosmosx_torch.utils.quantize import pitched_codes

    codes = torch.zeros(64, 50, dtype=torch.int8)
    assert tqm._code_pitch(pitched_codes(codes)) == 64
    assert tqm._code_pitch(codes) == 50
    assert tqm._code_pitch(torch.zeros(3, 64, 128, dtype=torch.int8)) == 128
    assert tqm._code_pitch(
        torch.zeros(3, 64, 256, dtype=torch.int8)[:, :, :128]) == 256
    with pytest.raises(ValueError, match="unit stride"):
        tqm._code_pitch(torch.zeros(50, 64, dtype=torch.int8).t())
    with pytest.raises(ValueError, match="layers K rows apart"):
        tqm._code_pitch(torch.zeros(3, 70, 128, dtype=torch.int8)[:, :64])
    with pytest.raises(ValueError, match="int8"):
        tqm._code_pitch(codes.float())


def test_tickets_grow_and_keep_the_older_buffers():
    """``_tickets`` hands out the newest buffer while it is large enough,
    then a larger zeroed one, and keeps the older buffers (a CUDA graph
    captured earlier may still point at them)."""
    dev = torch.device("cpu")
    saved = tqm._TICKETS.pop(dev.index, None)
    try:
        first = tqm._tickets(dev, 10)
        assert first.numel() == 1024 and first.dtype == torch.int32
        assert not first.any() and tqm._tickets(dev, 1024) is first
        grown = tqm._tickets(dev, 1500)
        assert grown.numel() >= 2048 and not grown.any()
        assert tqm._TICKETS[dev.index] == [first, grown]
        assert tqm._tickets(dev, 7) is grown
    finally:
        tqm._TICKETS.pop(dev.index, None)
        if saved is not None:
            tqm._TICKETS[dev.index] = saved
