"""The port's multi-device dry run (compairr_tpu_torch/graft_entry.py,
the counterpart of __graft_entry__.dryrun_multichip) on the CPU over 8
shards: sharded and ring matrices, CLI bytes on 1 and 8 devices and a
two-process run, each exactly equal to one device's."""


def test_dryrun_multichip_8(capsys):
    from compairr_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    assert "matrix sum 238" in capsys.readouterr().out
