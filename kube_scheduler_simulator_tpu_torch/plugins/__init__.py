"""Out-of-tree plugins: import a module here to register its plain bodies
and its bodies in the kernels (the analogue of the reference's out-of-tree
registry, simulator/scheduler/plugin/plugins.go:22-44).

    import kube_scheduler_simulator_tpu_torch.plugins.networkbandwidth  # registers

After the import, a KubeSchedulerConfiguration may enable the plugin by
name at its extension points; strict mode accepts it, the engines run it
on the card (csrc/seq_kernels.cu) and on the CPU (the plain bodies), and
preemption dry runs account for it. A plugin registered without a kernel
id has no body on the card: strict engines refuse it.
"""
