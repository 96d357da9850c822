"""Twin of tests/test_utils.py:58 on the port's ``MetricsWriter``
(``pnode_tpu_torch/utils/metrics.py``)."""

import json

from pnode_tpu_torch.utils import MetricsWriter


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path), use_tensorboard=False)
    w.add_scalar("Train/Loss", 0.5, 1)
    w.add_scalar("Train/Loss", 0.25, 2)
    w.close()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    recs = [json.loads(x) for x in lines]
    assert recs[1]["value"] == 0.25 and recs[1]["step"] == 2
    assert recs[0]["tag"] == "Train/Loss" and recs[0]["value"] == 0.5
