"""The port's metrics dictionary: every `cep_*` series the port registers,
with its labels and its kind (ctr, gauge or hist).

It ships with the package, so the static gate's metrics checker
(`analysis/metrics_check.py`) can hold the port's registrations against it
in any checkout of the code. PERF.md carries the same section under the
same markers for its readers; wherever PERF.md has it, the checker holds
the two equal (CEP-M04). Add a metric here and in PERF.md together.
Each entry means what the JAX package's dictionary (in PERF.md) says
unless its line says otherwise; the port registers no
cep_engine_fallback, cep_compile_flops or cep_compile_bytes.

<!-- ceplint-torch:metrics-dictionary:begin -->
- Spine (`ops/profiling.py`): `cep_advance_dispatch_seconds`,
  `cep_post_dispatch_seconds`, `cep_drain_seconds`,
  `cep_drain_pull_seconds`, `cep_decode_seconds`, `cep_emit_latency_seconds`
  (hist); `cep_batches_total`, `cep_drains_total`, `cep_slots_total`,
  `cep_matches_total`, `cep_drain_bytes_total` (ctr); `cep_tunnel_mbps`,
  `cep_profiler_unavailable{reason}` (gauge).
- Engine (`parallel/batched.py`, `ops/device_nfa.py`):
  `cep_engine_info{instance, engine, drain_mode}`, `cep_gc_phase{instance}`,
  `cep_pend_occupancy{instance}`, `cep_region_fill{instance}`,
  `cep_lane_occupancy{instance}`, `cep_pending_matches{instance}`,
  `cep_chain_depth_max{instance}`, `cep_replay_ledger_overflow{instance}`,
  `cep_fold_divergence_detected{instance}`,
  `cep_engine_state_counter{instance, counter}`,
  `cep_shard_state_counter{instance, counter, shard}`, `cep_device_runs`
  (gauge); `cep_gc_flushes_total`, `cep_auto_drains_total{trigger}`,
  `cep_replays_total`, `cep_device_state_total{counter}`,
  `cep_overflow_backpressure_total`, `cep_overflow_dropped_total{counter}`,
  `cep_provenance_sampled_total{query}`, `cep_engine_resizes_total`,
  `cep_sink_matches_total{query, format}`, `cep_sink_bytes_total{query,
  format}` (ctr); `cep_advance_compute_seconds{instance, phase}` (hist;
  CUDA-event walls on the card).
- Kernel builds (`obs/compile.py`): `cep_compiles_total{fn}` (ctr) — new
  kernel signatures (a generated step-kernel source: an nvcc build on the
  card unless cached), each counted once a registry;
  `cep_compile_seconds{fn}` (hist) — wall of the build or cache load that
  made it loadable. Spans (`obs/trace.py`): `cep_span_seconds{span}` (hist),
  `cep_span_total{span}` (ctr). Faults (`faults/injection.py`):
  `cep_faults_injected_total{site}`, `cep_retries_total{site}` (ctr).
- Streams (`streams/`): `cep_processor_records_total{query}`,
  `cep_processor_matches_total{query}`,
  `cep_processor_skipped_total{query}`, `cep_processor_errors_total{query}`,
  `cep_device_processor_flushes_total{query}`,
  `cep_device_processor_matches_total{query}`,
  `cep_driver_polls_total{group}`, `cep_driver_records_total{group}`,
  `cep_driver_commits_total{group}`, `cep_driver_reports_total{group}`,
  `cep_driver_dead_letters_total{topic, reason}`,
  `cep_driver_restore_failures_total{group}`,
  `cep_emit_deduped_total{query}`, `cep_checkpoint_corrupt_total` (ctr);
  `cep_driver_restore_seconds{group}`, `cep_driver_restored_records{group}`
  (gauge); `cep_match_latency_seconds{query}` (hist).
- Event time (`time/gate.py`): `cep_late_dropped_total{query}`,
  `cep_late_sideoutput_total{query}`, `cep_late_admitted_total{query}`,
  `cep_reorder_released_total{query}`,
  `cep_reorder_overflow_dropped_total{query}`,
  `cep_reorder_backpressure_total{query}` (ctr);
  `cep_reorder_occupancy{query}`, `cep_watermark_lag_seconds{query}`
  (gauge).
- Transport (`streams/transport.py`, `streams/partition.py`):
  `cep_transport_frames_total{role, dir}`, `cep_transport_bytes_total{role,
  dir}`, `cep_transport_torn_frames_total{role}`,
  `cep_transport_retries_total{site}`, `cep_transport_reconnects_total`,
  `cep_transport_disconnects_total{cause}`, `cep_transport_stalls_total`,
  `cep_transport_backpressure_total`, `cep_transport_dedup_total`,
  `cep_transport_server_restarts_total`,
  `cep_transport_broker_requests_total{broker, op}`,
  `cep_transport_broker_errors_total{broker}` (ctr);
  `cep_transport_connections{role}`, `cep_transport_inflight_appends`,
  `cep_transport_last_ok_age_seconds`, `cep_transport_sessions`,
  `cep_transport_broker_up{broker}` (gauge).
- Rebalance (`streams/rebalance.py`):
  `cep_rebalance_migrations_total{reason}`,
  `cep_rebalance_partition_moves_total`, `cep_rebalance_moved_records_total`
  (ctr); `cep_rebalance_fenced_shards`, `cep_rebalance_duration_seconds`,
  `cep_rebalance_checkpoint_bytes` (gauge). Auto runtime
  (`streams/auto_router.py`): `cep_auto_promotions_total{query}` (ctr);
  `cep_auto_runtime{query, runtime}` (gauge; runtime host or cuda). Fleet
  controller (`ops/controller.py`): `cep_slo_burn_rate{slo}`,
  `cep_controller_shard_load{shard}` (gauge);
  `cep_slo_burn_breaches_total{slo}`, `cep_controller_ticks_total`,
  `cep_controller_scrape_errors_total{device}`,
  `cep_controller_actions_total{kind}` (ctr).
- Controllers (`parallel/drain_sched.py`):
  `cep_drain_controller_target_emit_ms{query}`,
  `cep_drain_controller_gc_group{query}`,
  `cep_drain_controller_p99_ms{query}`,
  `cep_drain_controller_occupancy_ratio{query}`,
  `cep_autosize_lanes{query}`, `cep_autosize_nodes{query}`,
  `cep_autosize_matches{query}`, `cep_autosize_t{query}`,
  `cep_driver_poll_batch{group}` (gauge);
  `cep_drain_controller_adjustments_total{query, knob}`,
  `cep_autosize_resizes_total{query, axis, direction}` (ctr).
<!-- ceplint-torch:metrics-dictionary:end -->
"""
