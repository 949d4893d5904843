"""The linter on the configurations the port serves, at full scale and
reduced, on the CPU: params and caches are fake tensors, so a 15B-parameter
configuration lints without allocating a weight.  Every entry point the
port has (decode, paged decode, prefill, the kernel pipeline) must come
out clean with the kernel path forced; the CLI's ``--config`` run at full
scale exits 0.  Graph rules only: no numbers, no tolerance."""

import pytest

from repro_torch.analysis import PORTED_ENTRIES, lint_config
from repro_torch.analysis.__main__ import main as cli_main


def test_cli_full_scale_smollm_exits_zero(capsys):
    rc = cli_main(["--config", "smollm-360m", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean: 0 findings over decode, decode_paged, prefill, kernel" \
        in out


@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ["yi-6b", "minitron-8b", "starcoder2-15b"])
def test_served_configs_lint_clean(arch, reduced):
    report = lint_config(arch, reduced=reduced, device="cpu")
    assert report.entries == list(PORTED_ENTRIES)
    assert report.ok, report.render()


def test_zamba2_full_scale_decode_lints_clean(capsys):
    """zamba2-1.2b as shipped (36 Mamba2 blocks and the shared attention
    block at both of its invocations): its decode entry at full scale is
    clean, through the CLI, which skips the paged decode and the fused
    prefill that the pattern does not have."""
    rc = cli_main(["--config", "zamba2-1.2b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "clean: 0 findings over decode, kernel" in out
