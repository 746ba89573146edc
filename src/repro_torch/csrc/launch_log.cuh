// What a library's entry points really launched, read from the host.
//
// Every launch site calls log_launch(cluster) after the launch was
// accepted, with the cluster dimension it launched with (1 without a
// cluster).  he2_launch_log reports, since its previous call, the number
// of launches and the cluster dimensions of the first kLogCap of them, in
// launch order, and starts a new count.  Each .cu file is its own
// library with its own log.
#pragma once

namespace he2 {

constexpr int kLogCap = 8;

struct LaunchLog {
  long long launches = 0;
  long long cluster[kLogCap] = {};
};

// Internal linkage: an inline variable would be one symbol shared by
// every library loaded into the process.
static LaunchLog g_launch_log;

static inline void log_launch(unsigned cluster) {
  if (g_launch_log.launches < kLogCap)
    g_launch_log.cluster[g_launch_log.launches] = cluster;
  ++g_launch_log.launches;
}

}  // namespace he2

// out[0] = launches since the previous call; out[1 + i] = the cluster
// dimension of launch i, for i < min(out[0], kLogCap).
extern "C" void he2_launch_log(long long* out) {
  out[0] = he2::g_launch_log.launches;
  for (int i = 0; i < he2::kLogCap; ++i) out[1 + i] = he2::g_launch_log.cluster[i];
  he2::g_launch_log = he2::LaunchLog{};
}
